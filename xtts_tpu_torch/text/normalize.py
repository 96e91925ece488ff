"""Chinese text normalization (NSW -> spoken Mandarin).

Behavior-faithful re-implementation of the reference's vendored PaddleSpeech
normalizer (ttts/gpt/text/zh_normalization/: text_normlization.py rule
cascade, num.py, chronology.py, phonecode.py, quantifier.py,
char_convert.py). Differentially tested against the reference normalizer in
tests/test_reference_parity.py — rule ORDER and edge behaviors (phone
grouping with 、幺 digits, 十二点半, 零下...度, leading-一十 elision,
trailing-zero decimal stripping) are all pinned there.

Known reference quirks reproduced on purpose (so outputs are identical):
* time ranges check the FIRST range's minute for the ":30 -> 半" elision of
  the second time (chronology.py:77 uses `minute`, not `minute_2`);
* "¥/￥" are left unverbalized; `%` of a bare number reads 百分之 but the
  currency symbol does not become 元;
* any >=3-digit integer that survives the earlier rules is read digit-by-
  digit with 幺 for 1 (num.py RE_DEFAULT_NUM) — e.g. standalone 12345678.
"""
from __future__ import annotations

import re
import string
from typing import List

from xtts_tpu_torch.text.trad_simp_data import traditional_to_simplified

DIGITS = "零一二三四五六七八九"
# powers of ten with a dedicated character (num.py UNITS)
UNITS = {1: "十", 2: "百", 3: "千", 4: "万", 8: "亿"}

# quantifier alternation (data constant; num.py COM_QUANTIFIERS)
COM_QUANTIFIERS = (
    "(封|艘|把|目|套|段|人|所|朵|匹|张|座|回|场|尾|条|个|首|阙|阵|网|炮|"
    "顶|丘|棵|只|支|袭|辆|挑|担|颗|壳|窠|曲|墙|群|腔|砣|座|客|贯|扎|捆|刀|"
    "令|打|手|罗|坡|山|岭|江|溪|钟|队|单|双|对|出|口|头|脚|板|跳|枝|件|贴|"
    "针|线|管|名|位|身|堂|课|本|页|家|户|层|丝|毫|厘|分|钱|两|斤|担|铢|石|"
    "钧|锱|忽|(千|毫|微)克|毫|厘|(公)分|分|寸|尺|丈|里|寻|常|铺|程|"
    "(千|分|厘|毫|微)米|米|撮|勺|合|升|斗|石|盘|碗|碟|叠|桶|笼|盆|盒|杯|"
    "钟|斛|锅|簋|篮|盘|桶|罐|瓶|壶|卮|盏|箩|箱|煲|啖|袋|钵|年|月|日|季|刻|"
    "时|周|天|秒|分|小时|旬|纪|岁|世|更|夜|春|夏|秋|冬|代|伏|辈|丸|泡|粒|"
    "颗|幢|堆|条|根|支|道|面|片|张|颗|块|元|(亿|千万|百万|万|千|百)|"
    "(亿|千万|百万|万|千|百|美|)元|(亿|千万|百万|万|千|百|十|)吨|"
    "(亿|千万|百万|万|千|百|)块|角|毛|分)"
)

# unit abbreviations spoken in Mandarin (quantifier.py measure_dict):
# only EXACT alphanumeric-run matches are replaced ("70kg" is one run and
# stays; a standalone "kg" becomes 千克)
MEASURE_DICT = {
    "cm2": "平方厘米", "cm²": "平方厘米", "cm3": "立方厘米",
    "cm³": "立方厘米", "cm": "厘米", "db": "分贝", "ds": "毫秒",
    "kg": "千克", "km": "千米", "m2": "平方米", "m²": "平方米",
    "m³": "立方米", "m3": "立方米", "ml": "毫升", "m": "米",
    "mm": "毫米", "s": "秒",
}

# full/half width folding: letters, digits, ideographic space — NOT
# punctuation (，。！？ stay fullwidth like the reference, constants.py)
_F2H = {ord(c) + 65248: ord(c) for c in string.ascii_letters + string.digits}
_F2H[0x3000] = 0x20


# ---------------------------------------------------------------------------
# number verbalization core (num.py semantics)
# ---------------------------------------------------------------------------

def _cardinal_symbols(value: str, use_zero: bool = True) -> List[str]:
    """Recursive place-value expansion (num.py _get_value)."""
    stripped = value.lstrip("0")
    if not stripped:
        return []
    if len(stripped) == 1:
        if use_zero and len(stripped) < len(value):
            return [DIGITS[0], DIGITS[int(stripped)]]
        return [DIGITS[int(stripped)]]
    largest = next(p for p in sorted(UNITS, reverse=True) if p < len(stripped))
    head, tail = value[:-largest], value[-largest:]
    return _cardinal_symbols(head) + [UNITS[largest]] + _cardinal_symbols(tail)


def verbalize_cardinal(value: str) -> str:
    """Integer string -> spoken form; a leading 一十 elides to 十."""
    if not value:
        return ""
    value = value.lstrip("0")
    if not value:
        return DIGITS[0]
    syms = _cardinal_symbols(value)
    if len(syms) >= 2 and syms[0] == DIGITS[1] and syms[1] == UNITS[1]:
        syms = syms[1:]
    return "".join(syms)


def verbalize_digit(value: str, alt_one: bool = False) -> str:
    """Digit-by-digit reading; alt_one reads 1 as 幺 (phone numbers)."""
    out = "".join(DIGITS[int(c)] if c.isdigit() else c for c in value)
    return out.replace("一", "幺") if alt_one else out


def num2str(value: str) -> str:
    """integer[.decimal] -> spoken form; trailing decimal zeros stripped."""
    parts = value.split(".")
    integer = parts[0]
    decimal = parts[1] if len(parts) == 2 else ""
    result = verbalize_cardinal(integer)
    decimal = decimal.rstrip("0")
    if decimal:
        result = result or DIGITS[0]
        result += "点" + verbalize_digit(decimal)
    return result


# backwards-compatible helper names used elsewhere in the package
def num_to_zh(value: str, drop_leading_one: bool = True) -> str:
    return verbalize_cardinal(value)


def digits_to_zh(value: str) -> str:
    return verbalize_digit(value, alt_one=True)


def digits_to_zh_plain(value: str) -> str:
    return verbalize_digit(value)


def decimal_to_zh(value: str) -> str:
    sign = ""
    if value and value[0] in "+-":
        sign = "正" if value[0] == "+" else "负"
        value = value[1:]
    return sign + num2str(value)


# ---------------------------------------------------------------------------
# regex cascade (text_normlization.py:120-150 order)
# ---------------------------------------------------------------------------

RE_DATE = re.compile(r"(\d{4}|\d{2})年"
                     r"((0?[1-9]|1[0-2])月)?"
                     r"(((0?[1-9])|((1|2)[0-9])|30|31)([日号]))?")
RE_DATE2 = re.compile(
    r"(\d{4})([- /.])(0[1-9]|1[012])\2(0[1-9]|[12][0-9]|3[01])")
RE_TIME = re.compile(r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?")
RE_TIME_RANGE = re.compile(
    r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?"
    r"(~|-)"
    r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?")
RE_TEMPERATURE = re.compile(r"(-?)(\d+(\.\d+)?)(°C|℃|度|摄氏度)")
RE_MEASURE = re.compile(r"[a-zA-Z0-9]+")
RE_FRAC = re.compile(r"(-?)(\d+)/(\d+)")
RE_PERCENTAGE = re.compile(r"(-?)(\d+(\.\d+)?)%")
RE_MOBILE_PHONE = re.compile(
    r"(?<!\d)((\+?86 ?)?1([38]\d|5[0-35-9]|7[678]|9[89])\d{8})(?!\d)")
RE_TELEPHONE = re.compile(
    r"(?<!\d)((0(10|2[1-3]|[3-9]\d{2})-?)?[1-9]\d{6,7})(?!\d)")
RE_NATIONAL_UNIFORM_NUMBER = re.compile(r"(400)(-)?\d{3}(-)?\d{4}")
RE_RANGE = re.compile(
    r"((-?)((\d+)(\.\d+)?)|(\.(\d+)))[-~]((-?)((\d+)(\.\d+)?)|(\.(\d+)))")
RE_INTEGER = re.compile(r"(-)(\d+)")
RE_DECIMAL_NUM = re.compile(r"(-?)((\d+)(\.\d+))|(\.(\d+))")
RE_POSITIVE_QUANTIFIERS = re.compile(r"(\d+)([多余几\+])?" + COM_QUANTIFIERS)
RE_DEFAULT_NUM = re.compile(r"\d{3}\d*")
RE_NUMBER = re.compile(r"(-?)((\d+)(\.\d+)?)|(\.(\d+))")


def _time_num2str(num: str) -> str:
    """Zero-prefixed time component: 05 -> 零五 (chronology.py:22-27)."""
    result = num2str(num.lstrip("0"))
    if num.startswith("0"):
        result = DIGITS[0] + result
    return result


def _sub_time(m: re.Match) -> str:
    is_range = len(m.groups()) > 5
    hour, minute, second = m.group(1), m.group(2), m.group(4)
    result = f"{num2str(hour)}点"
    if minute.lstrip("0"):
        result += "半" if int(minute) == 30 else f"{_time_num2str(minute)}分"
    if second and second.lstrip("0"):
        result += f"{_time_num2str(second)}秒"
    if is_range:
        hour2, minute2, second2 = m.group(6), m.group(7), m.group(9)
        result += "至" + f"{num2str(hour2)}点"
        if minute2.lstrip("0"):
            # reference quirk: tests the FIRST minute here (chronology.py:77)
            result += ("半" if int(minute) == 30
                       else f"{_time_num2str(minute2)}分")
        if second2 and second2.lstrip("0"):
            result += f"{_time_num2str(second2)}秒"
    return result


def _sub_date(m: re.Match) -> str:
    out = ""
    if m.group(1):
        out += f"{verbalize_digit(m.group(1))}年"
    if m.group(3):
        out += f"{verbalize_cardinal(m.group(3))}月"
    if m.group(5):
        out += f"{verbalize_cardinal(m.group(5))}{m.group(9)}"
    return out


def _sub_date2(m: re.Match) -> str:
    return (f"{verbalize_digit(m.group(1))}年"
            f"{verbalize_cardinal(m.group(3))}月"
            f"{verbalize_cardinal(m.group(4))}日")


def _sub_temperature(m: re.Match) -> str:
    sign = "零下" if m.group(1) else ""
    # reference bug reproduced: it compares group(3) (the DECIMAL part, not
    # the unit in group(4)) against 摄氏度 (quantifier.py:50-55), so the
    # unit effectively always reads 度
    unit = "摄氏度" if m.group(3) == "摄氏度" else "度"
    return f"{sign}{num2str(m.group(2))}{unit}"


def _sub_measure(m: re.Match) -> str:
    return MEASURE_DICT.get(m.group(), m.group())


def _sub_frac(m: re.Match) -> str:
    sign = "负" if m.group(1) else ""
    return f"{sign}{num2str(m.group(3))}分之{num2str(m.group(2))}"


def _sub_percentage(m: re.Match) -> str:
    sign = "负" if m.group(1) else ""
    return f"{sign}百分之{num2str(m.group(2))}"


def _sub_mobile(m: re.Match) -> str:
    parts = m.group(0).strip("+").split()
    return "，".join(verbalize_digit(p, alt_one=True) for p in parts)


def _sub_phone(m: re.Match) -> str:
    parts = m.group(0).split("-")
    return "，".join(verbalize_digit(p, alt_one=True) for p in parts)


def _sub_number(m: re.Match) -> str:
    pure_decimal = m.group(5)
    if pure_decimal:
        return num2str(pure_decimal)
    sign = "负" if m.group(1) else ""
    return f"{sign}{num2str(m.group(2))}"


def _sub_range(m: re.Match) -> str:
    first, second = m.group(1), m.group(8)
    return (f"{RE_NUMBER.sub(_sub_number, first)}到"
            f"{RE_NUMBER.sub(_sub_number, second)}")


def _sub_negative(m: re.Match) -> str:
    return f"负{num2str(m.group(2))}"


def _sub_quantifier(m: re.Match) -> str:
    extra = m.group(2) or ""
    if extra == "+":
        extra = "多"
    return f"{num2str(m.group(1))}{extra}{m.group(3)}"


def _sub_default_num(m: re.Match) -> str:
    return verbalize_digit(m.group(0), alt_one=True)


# symbol verbalization pass (text_normlization.py _post_replace)
_POST_REPLACE = [
    ("/", "每"), ("~", "至"), ("～", "至"),
    ("①", "一"), ("②", "二"), ("③", "三"), ("④", "四"), ("⑤", "五"),
    ("⑥", "六"), ("⑦", "七"), ("⑧", "八"), ("⑨", "九"), ("⑩", "十"),
    ("α", "阿尔法"), ("β", "贝塔"), ("γ", "伽玛"), ("Γ", "伽玛"),
    ("δ", "德尔塔"), ("Δ", "德尔塔"), ("ε", "艾普西龙"), ("ζ", "捷塔"),
    ("η", "依塔"), ("θ", "西塔"), ("Θ", "西塔"), ("ι", "艾欧塔"),
    ("κ", "喀帕"), ("λ", "拉姆达"), ("Λ", "拉姆达"), ("μ", "缪"),
    ("ν", "拗"), ("ξ", "克西"), ("Ξ", "克西"), ("ο", "欧米克伦"),
    ("π", "派"), ("Π", "派"), ("ρ", "肉"), ("ς", "西格玛"),
    ("Σ", "西格玛"), ("σ", "西格玛"), ("τ", "套"), ("υ", "宇普西龙"),
    ("φ", "服艾"), ("Φ", "服艾"), ("χ", "器"), ("ψ", "普赛"),
    ("Ψ", "普赛"), ("ω", "欧米伽"), ("Ω", "欧米伽"),
]

_SPECIAL_FILTER = re.compile(r"[——《》【】<=>{}()（）#&@“”^_|…\\]")


class TextNormalizer:
    """Entry points mirroring the reference TextNormalizer
    (zh_normalization/text_normlization.py:54-156)."""

    SENTENCE_SPLITOR = re.compile(r"([：、，；。？！,;?!][”’]?)")

    def _split(self, text: str, lang: str = "zh") -> List[str]:
        if lang == "zh":
            text = text.replace(" ", "")
            text = _SPECIAL_FILTER.sub("", text)
        text = self.SENTENCE_SPLITOR.sub(r"\1\n", text).strip()
        return [s.strip() for s in re.split(r"\n+", text)]

    def _post_replace(self, sentence: str) -> str:
        for a, b in _POST_REPLACE:
            sentence = sentence.replace(a, b)
        return sentence

    def normalize_sentence(self, sentence: str) -> str:
        sentence = traditional_to_simplified(sentence)
        sentence = sentence.translate(_F2H)

        sentence = RE_DATE.sub(_sub_date, sentence)
        sentence = RE_DATE2.sub(_sub_date2, sentence)
        sentence = RE_TIME_RANGE.sub(_sub_time, sentence)
        sentence = RE_TIME.sub(_sub_time, sentence)
        sentence = RE_TEMPERATURE.sub(_sub_temperature, sentence)
        sentence = RE_MEASURE.sub(_sub_measure, sentence)
        sentence = RE_FRAC.sub(_sub_frac, sentence)
        sentence = RE_PERCENTAGE.sub(_sub_percentage, sentence)
        sentence = RE_MOBILE_PHONE.sub(_sub_mobile, sentence)
        sentence = RE_TELEPHONE.sub(_sub_phone, sentence)
        sentence = RE_NATIONAL_UNIFORM_NUMBER.sub(_sub_phone, sentence)
        sentence = RE_RANGE.sub(_sub_range, sentence)
        sentence = RE_INTEGER.sub(_sub_negative, sentence)
        sentence = RE_DECIMAL_NUM.sub(_sub_number, sentence)
        sentence = RE_POSITIVE_QUANTIFIERS.sub(_sub_quantifier, sentence)
        sentence = RE_DEFAULT_NUM.sub(_sub_default_num, sentence)
        sentence = RE_NUMBER.sub(_sub_number, sentence)
        return self._post_replace(sentence)

    def normalize(self, text: str) -> List[str]:
        return [self.normalize_sentence(s) for s in self._split(text)]
