"""Built-in char/word -> pinyin lexicon (G2P fallback when pypinyin is absent).

The reference outsources grapheme-to-phoneme entirely to the pypinyin package
(ttts/gpt/text/chinese.py:5,105-108). To keep this framework hermetic on TPU
hosts without that wheel, a compact lexicon of the most frequent simplified
characters plus a polyphone word table is bundled. pypinyin, when importable,
still takes precedence (xtts_tpu_torch/text/pinyin.py).

Char token format: the hanzi immediately followed by its syllable+tone, e.g.
"好hao3"; word entries are "word:syl1,syl2". Tone 5 is the neutral tone.
"""

_CHAR_DATA = """
的de5 一yi1 是shi4 了le5 我wo3 不bu4 人ren2 在zai4 他ta1 有you3 这zhe4 个ge4
上shang4 们men5 来lai2 到dao4 时shi2 大da4 地di4 为wei4 子zi3 中zhong1 你ni3 说shuo1
生sheng1 国guo2 年nian2 着zhe5 就jiu4 那na4 和he2 要yao4 她ta1 出chu1 也ye3 得de2
里li3 后hou4 自zi4 以yi3 会hui4 家jia1 可ke3 下xia4 而er2 过guo4 天tian1 去qu4
能neng2 对dui4 小xiao3 多duo1 然ran2 于yu2 心xin1 学xue2 么me5 之zhi1 都dou1 好hao3
看kan4 起qi3 发fa1 当dang1 没mei2 成cheng2 只zhi3 如ru2 事shi4 把ba3 还hai2 用yong4
第di4 样yang4 道dao4 想xiang3 作zuo4 种zhong3 开kai1 美mei3 总zong3 从cong2 无wu2 情qing2
己ji3 面mian4 最zui4 女nv3 但dan4 现xian4 前qian2 些xie1 所suo3 同tong2 日ri4 手shou3
又you4 行xing2 意yi4 动dong4 方fang1 期qi1 它ta1 头tou2 经jing1 长chang2 儿er2 回hui2
位wei4 分fen1 爱ai4 老lao3 因yin1 很hen3 给gei3 名ming2 法fa3 间jian1 斯si1 知zhi1
世shi4 什shen2 两liang3 次ci4 使shi3 身shen1 者zhe3 被bei4 高gao1 已yi3 亲qin1 其qi2
进jin4 此ci3 话hua4 常chang2 与yu3 活huo2 正zheng4 感gan3 见jian4 明ming2 问wen4 力li4
理li3 尔er3 点dian3 文wen2 几ji3 定ding4 本ben3 公gong1 特te4 做zuo4 外wai4 孩hai2
相xiang1 西xi1 果guo3 走zou3 将jiang1 月yue4 十shi2 实shi2 向xiang4 声sheng1 车che1 全quan2
信xin4 重zhong4 三san1 机ji1 工gong1 物wu4 气qi4 每mei3 并bing4 别bie2 真zhen1 打da3
太tai4 新xin1 比bi3 才cai2 便bian4 夫fu1 再zai4 书shu1 部bu4 水shui3 像xiang4 眼yan3
等deng3 体ti3 却que4 加jia1 电dian4 主zhu3 界jie4 门men2 利li4 海hai3 受shou4 听ting1
表biao3 德de2 少shao3 克ke4 代dai4 员yuan2 许xu3 先xian1 口kou3 由you2 死si3 安an1
写xie3 性xing4 马ma3 光guang1 白bai2 或huo4 住zhu4 难nan2 望wang4 教jiao4 命ming4 花hua1
结jie2 乐le4 色se4 更geng4 拉la1 东dong1 神shen2 记ji4 处chu4 让rang4 母mu3 父fu4
应ying1 直zhi2 字zi4 场chang3 平ping2 报bao4 友you3 关guan1 放fang4 至zhi4 张zhang1 认ren4
接jie1 告gao4 入ru4 笑xiao4 内nei4 英ying1 军jun1 候hou4 民min2 岁sui4 往wang3 何he2
度du4 山shan1 觉jue2 路lu4 带dai4 万wan4 男nan2 边bian1 风feng1 解jie3 叫jiao4 任ren4
金jin1 快kuai4 原yuan2 吃chi1 妈ma1 变bian4 通tong1 师shi1 立li4 象xiang4 数shu4 四si4
失shi1 满man3 战zhan4 远yuan3 格ge2 士shi4 音yin1 轻qing1 目mu4 条tiao2 呢ne5 病bing4
始shi3 达da2 深shen1 完wan2 今jin1 提ti2 求qiu2 清qing1 王wang2 化hua4 空kong1 业ye4
思si1 切qie4 怎zen3 非fei1 找zhao3 片pian4 罗luo2 钱qian2 吗ma5 语yu3 元yuan2 喜xi3
曾ceng2 离li2 飞fei1 科ke1 言yan2 干gan4 流liu2 欢huan1 约yue1 各ge4 即ji2 指zhi3
合he2 反fan3 题ti2 必bi4 该gai1 论lun4 交jiao1 终zhong1 林lin2 请qing3 医yi1 晚wan3
制zhi4 球qiu2 决jue2 传chuan2 画hua4 保bao3 读du2 运yun4 及ji2 则ze2 房fang2 早zao3
院yuan4 量liang4 苦ku3 火huo3 布bu4 品pin3 近jin4 坐zuo4 产chan3 答da2 星xing1 精jing1
视shi4 五wu3 连lian2 司si1 巴ba1 奇qi2 管guan3 类lei4 未wei4 朋peng2 且qie3 婚hun1
台tai2 夜ye4 青qing1 北bei3 队dui4 久jiu3 乎hu1 越yue4 观guan1 落luo4 尽jin3 形xing2
影ying3 红hong2 爸ba4 百bai3 令ling4 周zhou1 吧ba5 识shi2 步bu4 希xi1 亚ya4 术shu4
留liu2 市shi4 半ban4 热re4 送song4 兴xing4 造zao4 谈tan2 容rong2 极ji2 随sui2 演yan3
收shou1 首shou3 根gen1 讲jiang3 整zheng3 式shi4 取qu3 照zhao4 办ban4 强qiang2 石shi2 古gu3
华hua2 拿na2 计ji4 您nin2 装zhuang1 似si4 足zu2 双shuang1 妻qi1 尼ni2 转zhuan3 诉su4
米mi3 称cheng1 丽li4 客ke4 南nan2 领ling3 节jie2 衣yi1 站zhan4 黑hei1 刻ke4 统tong3
断duan4 福fu2 城cheng2 故gu4 历li4 惊jing1 脸lian3 选xuan3 包bao1 紧jin3 争zheng1 另ling4
建jian4 维wei2 绝jue2 树shu4 系xi4 伤shang1 示shi4 愿yuan4 持chi2 千qian1 史shi3 谁shei2
准zhun3 联lian2 妇fu4 纪ji4 基ji1 买mai3 志zhi4 静jing4 阿a1 诗shi1 独du2 复fu4
痛tong4 消xiao1 社she4 算suan4 义yi4 竟jing4 确que4 酒jiu3 需xu1 单dan1 治zhi4 卡ka3
幸xing4 兰lan2 念nian4 举ju3 仅jin3 钟zhong1 怕pa4 共gong4 毛mao2 句ju4 息xi1 功gong1
官guan1 待dai4 究jiu1 跟gen1 穿chuan1 室shi4 易yi4 游you2 程cheng2 号hao4 居ju1 考kao3
突tu1 皮pi2 艺yi4 局ju2 协xie2 际ji4 招zhao1 细xi4 灵ling2 规gui1 显xian3 微wei1
倒dao3 春chun1 香xiang1 营ying2 养yang3 遇yu4 虽sui1 脑nao3 介jie4 阵zhen4 页ye4 遍bian4
仍reng2 板ban3 副fu4 歌ge1 集ji2 既ji4 波bo1 划hua4 率lv4 初chu1 斗dou4 甚shen4
超chao1 负fu4 努nu3 温wen1 纸zhi3 婆po2 按an4 款kuan3 座zuo4 铁tie3 普pu3 围wei2
旧jiu4 颜yan2 段duan4 怀huai2 存cun2 武wu3 险xian3 毫hao2 油you2 食shi2 推tui1 依yi1
梦meng4 鱼yu2 错cuo4 降jiang4 停ting2 托tuo1 摆bai3 灰hui1 累lei4 典dian3 盘pan2 压ya1
差cha4 兵bing1 弟di4 竹zhu2 午wu3 伦lun2 尝chang2 毕bi4 练lian4 判pan4 研yan2 岛dao3
席xi2 哥ge1 抱bao4 鼓gu3 冷leng3 疑yi2 铺pu4 鲜xian1 置zhi4 排pai2 订ding4 缺que1
楼lou2 迷mi2 遗yi2 药yao4 辞ci2 层ceng2 豆dou4 闻wen2 予yu3 宝bao3 圆yuan2 醒xing3
追zhui1 免mian3 归gui1 雪xue3 刚gang1 姑gu1 夏xia4 哭ku1 秋qiu1 担dan1 唱chang4 弹tan2
伟wei3 刘liu2 威wei1 秒miao3 亿yi4 零ling2 六liu4 七qi1 八ba1 九jiu3 吨dun1 厘li2
摄she4 氏shi4 升sheng1 斤jin1 仪yi2 镜jing4 船chuan2 湖hu2 河he2 江jiang1 田tian2 桥qiao2
街jie1 云yun2 雨yu3 雷lei2 雾wu4 冰bing1 晴qing2 阴yin1 闪shan3 虹hong2 桌zhuo1 椅yi3
床chuang2 窗chuang1 墙qiang2 屋wu1 厅ting1 厨chu2 厕ce4 碗wan3 筷kuai4 杯bei1 瓶ping2 壶hu2
盒he2 箱xiang1 袋dai4 伞san3 帽mao4 鞋xie2 袜wa4 裤ku4 裙qun2 衫shan1 巾jin1 镇zhen4
乡xiang1 村cun1 县xian4 省sheng3 区qu1 港gang3 澳ao4 疆jiang1 藏zang4 蒙meng2 吉ji2 辽liao2
宁ning2 陕shan3 甘gan1 贵gui4 滇dian1 闽min3 粤yue4 桂gui4 琼qiong2 渝yu2 津jin1 沪hu4
杭hang2 蓉rong2 汉han4 郑zheng4 沈shen3 昆kun1 银yin2 郊jiao1 岸an4 滩tan1 谷gu3 峰feng1
坡po1 岭ling3 洞dong4 泉quan2 溪xi1 潭tan2 库ku4 坝ba4 渠qu2 沙sha1 漠mo4 草cao3
叶ye4 枝zhi1 藤teng2 仁ren2 壳ke2 梅mei2 菊ju2 荷he2 桃tao2 杏xing4 梨li2 枣zao3
橘ju2 橙cheng2 柚you4 瓜gua1 鸟niao3 虫chong2 龙long2 蛇she2 虎hu3 兔tu4 鼠shu3 牛niu2
羊yang2 猪zhu1 狗gou3 猫mao1 鸡ji1 鸭ya1 鹅e2 猴hou2 狮shi1 熊xiong2 狼lang2 鹿lu4
鹰ying1 雀que4 燕yan4 鸽ge1 鹤he4 蜂feng1 蝶die2 蚊wen2 蝇ying2 蚁yi3 蜘zhi1 蛛zhu1
虾xia1 蟹xie4 龟gui1 鲸jing1 豚tun2 贝bei4 螺luo2 蚌bang4 骨gu3 肉rou4 血xue4 汗han4
泪lei4 唇chun2 齿chi3 舌she2 喉hou2 咽yan1 肩jian1 背bei4 胸xiong1 腰yao1 腹fu4 臂bi4
腕wan4 掌zhang3 拳quan2 趾zhi3 膝xi1 踝huai2 脚jiao3 腿tui3 肚du4 脏zang4 肝gan1 肺fei4
肾shen4 胃wei4 肠chang2 脉mai4 筋jin1 魂hun2 魄po4 寿shou4 龄ling2 婴ying1 童tong2 叔shu1
舅jiu4 姨yi2 婶shen3 侄zhi2 孙sun1 嫂sao3 媳xi2 婿xu4 姐jie3 妹mei4 兄xiong1 爷ye2
奶nai3 姥lao3 娘niang2 爹die1 伯bo2 姆mu3 吵chao3 闹nao4 哄hong3 骂ma4 夸kua1 赞zan4
劝quan4 骗pian4 瞒man2 猜cai1 疼teng2 痒yang3 酸suan1 甜tian2 辣la4 咸xian2 淡dan4 腥xing1
臭chou4 浓nong2 稠chou2 稀xi1 嫩nen4 脆cui4 硬ying4 软ruan3 湿shi1 潮chao2 燥zao4 暖nuan3
凉liang2 烫tang4 沸fei4 冻dong4 融rong2 煮zhu3 蒸zheng1 炒chao3 煎jian1 炸zha2 烤kao3 炖dun4
焖men4 拌ban4 腌yan1 酿niang4 榨zha4 磨mo2 捣dao3 搅jiao3 剁duo4 削xiao1 剥bao1 撕si1
掰bai1 拧ning3 拎lin1 扛kang2 挑tiao1 抬tai2 搬ban1 挪nuo2 拖tuo1 拽zhuai4 扯che3 抓zhua1
捏nie1 掐qia1 拍pai1 敲qiao1 砸za2 捶chui2 踢ti1 踩cai3 跺duo4 蹦beng4 跳tiao4 蹲dun1
爬pa2 滚gun3 翻fan1 滑hua2 摔shuai1 跌die1 碰peng4 撞zhuang4 擦ca1 蹭ceng4 挤ji3 堆dui1
叠die2 盖gai4 咱zan2 俺an3 啥sha2 咋za3 哪na3 嘛ma5 哟yo5 哦o5 唉ai4 哎ai1
嗨hai1 喂wei4 呀ya5 哇wa1 哈ha1 嘿hei1 嘻xi1 呵he1 啦la5 咯lo5 呗bei5 噢o1
哼heng1 呜wu1 嘟du1 叮ding1 咚dong1 哗hua1 嗖sou1 砰peng1 轰hong1 隆long2 咔ka1 嚓ca1
滴di1 嗒da1 啪pa1 嘭peng1 呼hu1 吸xi1 喘chuan3 咳ke2 嗽sou4 喷pen1 嚏ti4 吞tun1
嚼jiao2 啃ken3 咬yao3 舔tian3 吻wen3 吹chui1 吐tu3 呕ou3 喊han3 嚷rang3 吼hou3 喃nan2
嘀di2 咕gu1 叨dao1 唠lao2 嘱zhu3 咐fu4 呆dai1 傻sha3 笨ben4 蠢chun3 聪cong1 慧hui4
智zhi4 愚yu2 贤xian2 孝xiao4 忠zhong1 诚cheng2 谦qian1 虚xu1 骄jiao1 傲ao4 谨jin3 慎shen4
勤qin2 懒lan3 馋chan2 贪tan1 廉lian2 耻chi3 荣rong2 辱ru3 誉yu4 谤bang4 欺qi1 凌ling2
侮wu3 尊zun1 敬jing4 慕mu4 仰yang3 抽chou1 插cha1 拔ba2 塞sai1 堵du3 封feng1 贴tie1
粘zhan1 缝feng2 补bu3 织zhi1 绣xiu4 剪jian3 裁cai2 绑bang3 捆kun3 扣kou4 拴shuan1 挂gua4
吊diao4 悬xuan2 垂chui2 飘piao1 荡dang4 摇yao2 晃huang4 抖dou3 颤chan4 震zhen4 摸mo1 触chu4
揉rou2 搓cuo1 捂wu3 遮zhe1 挡dang3 躲duo3 避bi4 逃tao2 赶gan3 逐zhu2 驱qu1 赴fu4
奔ben1 冲chong1 闯chuang3 撤che4 退tui4 返fan3 抵di3 驶shi3 驾jia4 骑qi2 乘cheng2 载zai4
输shu1 派pai4 遣qian3 投tou2 掷zhi4 扔reng1 抛pao1 丢diu1 捡jian3 拾shi2 捞lao1 捕bu3
捉zhuo1 逮dai3 擒qin2 猎lie4 钓diao4 割ge1 砍kan3 锯ju4 劈pi1 凿zao2 钻zuan1 挖wa1
掘jue2 埋mai2 填tian2 铲chan3 扫sao3 拭shi4 洗xi3 刷shua1 漂piao1 晒shai4 晾liang4 频pin2
例li4 倍bei4 均jun1 积ji1 商shang1 余yu2 偶ou3 质zhi4 角jiao3 锥zhui1 柱zhu4 轴zhou2
径jing4 弦xian2 弧hu2 线xian4 距ju4 宽kuan1 窄zhai3 厚hou4 薄bao2 粗cu1 矮ai3 瘦shou4
胖pang4 肥fei2 壮zhuang4 弱ruo4 残can2 健jian4 康kang1 症zheng4 疾ji2 疗liao2 诊zhen3 愈yu4
防fang2 疫yi4 菌jun1 毒du2 癌ai2 瘤liu2 疮chuang1 疤ba1 痕hen2 痊quan2 剂ji4 丸wan2
膏gao1 灸jiu3 针zhen1 灌guan4 泻xie4 泄xie4 漏lou4 渗shen4 浸jin4 泡pao4 溶rong2 溅jian4
洒sa3 浇jiao1 滋zi1 润run4 枯ku1 萎wei3 凋diao1 茂mao4 盛sheng4 衰shuai1 旺wang4 昌chang1
繁fan2 荒huang1 芜wu2 瘠ji2 沃wo4 饶rao2 政zheng4 府fu3 党dang3 团tuan2 组zu3 委wei3
级ji2 阶jie1 职zhi2 务wu4 权quan2 责ze2 益yi4 损sun3 害hai4 弊bi4 端duan1 策ce4
略lve4 谋mou2 案an4 宗zong1 旨zhi3 纲gang1 章zhang1 项xiang4 标biao1 范fan4 限xian4 额e2
衡heng2 鉴jian4 证zheng4 据ju4 凭ping2 仗zhang4 靠kao4 聘pin4 雇gu4 佣yong1 酬chou2 薪xin1
俸feng4 禄lu4 赏shang3 罚fa2 惩cheng2 戒jie4 律lv4 禁jin4 止zhi3 允yun3 批pi1 审shen3
核he2 查cha2 验yan4 测ce4 估gu1 预yu4 筹chou2 募mu4 捐juan1 赠zeng4 馈kui4 偿chang2
赔pei2 债zhai4 贷dai4 租zu1 赁lin4 售shou4 购gou4 销xiao1 贸mao4 汇hui4 兑dui4 币bi4
钞chao1 账zhang4 技ji4 创chuang4 颖ying3 奥ao4 秘mi4 妙miao4 玄xuan2 幻huan4 拟ni3 假jia3
伪wei3 仿fang3 版ban3 刊kan1 录lu4 播bo1 映ying4 幕mu4 屏ping2 键jian4 码ma3 芯xin1
网wang3 络luo4 缆lan3 塔ta3 器qi4 件jian4 储chu3 删shan1 改gai3 增zeng1 添tian1 减jian3
除chu2 导dao3 航hang2 巡xun2 逻luo2 察cha2 侦zhen1 探tan4 寻xun2 觅mi4 访fang3 询xun2
咨zi1 聊liao2 叙xu4 述shu4 评ping2 议yi4 辩bian4 驳bo2 斥chi4 谴qian3 怨yuan4 恨hen4
仇chou2 怒nu4 愤fen4 恼nao3 烦fan2 愁chou2 忧you1 虑lv4 焦jiao1 急ji2 躁zao4 慌huang1
恐kong3 惧ju4 畏wei4 怯qie4 羞xiu1 惭can2 愧kui4 悔hui3 憾han4 惜xi1 昨zuo2 嗓sang3
茶cha2 饭fan4 菜cai4 汤tang1 饼bing3 糕gao1 糖tang2 盐yan2 醋cu4 酱jiang4 粥zhou1 饺jiao3
馒man2 聚ju4 餐can1 宴yan4 喝he1 饮yin3 醉zui4 饿e4 渴ke3 饱bao3 尘chen2 垃la1
圾ji1 桶tong3 帮bang1 助zhu4 谢xie4 姓xing4 欧ou1 洲zhou1 丁ding1 俄e2 葡pu2 萄tao2
牙ya2 瑞rui4 芬fen1 捷jie2 匈xiong1 腊la4 耳er3 埃ai1 伊yi1 朗lang3 冬dong1 季ji4
暑shu3 寒han2 汛xun4 旱han4 涝lao4 灾zai1 啸xiao4 崩beng1 塌ta1 陷xian4 裂lie4 紫zi3
蓝lan2 绿lv4 黄huang2 粉fen3 棕zong1 褐he4 笔bi3 墨mo4 砚yan4 尺chi3 橡xiang4 胶jiao1
汪wang1 喵miao1 嗡weng1 叽ji1 喳zha1 辰chen2 宿xiu4 宇yu3 宙zhou4 卫wei4 箭jian4 舱cang1
轨gui3 磁ci2 引yin3 遥yao2 控kong4 讯xun4 爽shuang3 闷men1 贺he4 庆qing4 祝zhu4 嫁jia4
娶qu3 恋lian4

二er4 资zi1 展zhan3 设she4 州zhou1 族zu2 京jing1 济ji4 农nong2 广guang3 阳yang2 专zhuan1
皇huang2 土tu3 备bei4 具ju4 李li3 众zhong4 调diao4 革ge2 较jiao4 朝chao2 型xing2 价jia4
校xiao4 属shu3 图tu2 育yu4 参can1 帝di4 群qun2 构gou4 料liao4 势shi4 值zhi2 源yuan2
股gu3 速su4 支zhi1 况kuang4 境jing4 编bian1 列lie4 服fu2 企qi3 响xiang3 施shi1 低di1
般ban1 击ji1 素su4 护hu4 占zhan4 费fei4 试shi4 木mu4 左zuo3 央yang1 采cai3 底di3
宫gong1 环huan2 富fu4 若ruo4 严yan2 模mo2 胜sheng4 杀sha1 态tai4 破po4 承cheng2 杨yang2
须xu1 供gong1 续xu4 状zhuang4 域yu4 修xiu1 致zhi4 密mi4 旅lv3 赛sai4 效xiao4 玉yu4
获huo4 习xi2 陆lu4 右you4 攻gong1 检jian3 苏su1 注zhu4 抗kang4 劳lao2 户hu4 优you1
财cai2 适shi4 陈chen2 射she4 景jing3 印yin4 监jian1 配pei4 敌di2 园yuan2 征zheng1 善shan4
词ci2 继ji4 执zhi2 味wei4 份fen4 宣xuan1 著zhu4 辑ji2 剑jian4 礼li3 材cai2 洋yang2
架jia4 筑zhu4 括kuo4 乱luan4 尚shang4 良liang2 临lin2 激ji1 刀dao1 敢gan3 邦bang1 挥hui1
胡hu2 简jian3 荆jing1 守shou3 辖xia2 宜yi2 块kuai4 堂tang2 剧ju4 充chong1 够gou4 班ban1
坚jian1 吴wu2 换huan4 异yi4 某mou3 顾gu4 曲qu3 楚chu3 朱zhu1 救jiu4 宋song4 洪hong2
含han2 顺shun4 啊a5 败bai4 货huo4 矿kuang4 忙mang2 厂chang3 永yong3 沉chen2 散san4 松song1
渐jian4 顶ding3 训xun4 否fou3 督du1 丰feng1 献xian4 忽hu1 互hu4 亮liang4 纳na4 襄xiang1
登deng1 臣chen2 雄xiong2 鄂e4 召zhao4 暗an4 扩kuo4 祖zu3 齐qi2 短duan3 烈lie4 牌pai2
恩en1 移yi2 础chu3 露lu4 届jie4 卖mai4 植zhi2 授shou4 湾wan1 博bo2 庭ting2 陵ling2
固gu4 票piao4 杂za2 泽ze2 侧ce4 甲jia3 馆guan3 唐tang2 炮pao4 沿yan2 殿dian4 刺ci4
怪guai4 彩cai3 警jing3 索suo3 轮lun2 附fu4 旁pang2 罪zui4 枪qiang1 迎ying2 序xu4 慢man4
恶e4 顿dun4 危wei1 稳wen3 熟shu2 概gai4 操cao1 诸zhu1 佛fo2 折zhe2 野ye3 付fu4
肯ken3 罢ba4 嘴zui3 末mo4 巨ju4 培pei2 瓦wa3 犯fan4 困kun4 店dian4 拥yong1 圣sheng4
戏xi4 旗qi2 奖jiang3 岩yan2 廷ting2 烧shao1 析xi1 讨tao3 跑pao3 烟yan1 误wu4 仙xian1
舞wu3 亡wang2 闭bi4 汽qi4 伸shen1 脱tuo1 侵qin1 川chuan1 莫mo4 麻ma2 秀xiu4 借jie4
私si1 岗gang3 卷juan4 横heng2 驻zhu4 套tao4 兼jian1 君jun1 束shu4 夺duo2 袁yuan2 灯deng1
坏huai4 坦tan3 丝si1 瞧qiao2 择ze2 墓mu4 宪xian4 鲁lu3 庙miao4 掉diao4 丹dan1 御yu4
舰jian4 课ke4 延yan2 隐yin3 粮liang2 遭zao1 潜qian2 庄zhuang1 混hun4 奴nu2 赵zhao4 睡shui4
徐xu2 韦wei2 殖zhi2 拜bai4 扬yang2 址zhi3 洛luo4 休xiu1 纵zong4 染ran3 纷fen1 透tou4
灭mie4 蛋dan4 森sen1 狐hu2 郡jun4 缓huan3 迹ji4 释shi4 涓juan1 孔kong3 搜sou1 促cu4
钢gang1 寺si4 液ye4 坛tan2 珍zhen1 梁liang2 役yi4 偏pian1 迫po4 凡fan2 壁bi4 替ti4
税shui4 综zong1 盟meng2 韩han2 竞jing4 乌wu1 尤you2 秦qin2 珠zhu1 迅xun4 泥ni2 鬼gui3
纯chun2 睛jing1 刑xing2 途tu2 幅fu2 握wo4 奉feng4 谓wei4 崇chong2 享xiang3 绍shao4 铜tong2
呈cheng2 泛fan4 械xie4 欲yu4 措cuo4 爆bao4 暴bao4 签qian1 猛meng3 郭guo1 嘉jia1 障zhang4
缩suo1 亦yi4 废fei4 搞gao3 胞bao1 曰yue1 俗su2 绩ji4 阻zu3 萨sa4 勒le4 忘wang4
奏zou4 玩wan2 苹ping2 谱pu3 扭niu3 涨zhang3 抢qiang3 呐na5 吖a1 嘞lei5 噻sai1 哒da1
幺yao1 畅chang4

默mo4 莲lian2 篇pian1 纺fang3 截jie2 雅ya3 忍ren3 伙huo3 勇yong3 峡xia2 徒tu2
丈zhang4 尾wei3 泰tai4 佳jia1 伍wu3 署shu3 剩sheng4 贼zei2 冠guan1 倾qing1
申shen1 贫pin2 诺nuo4 麦mai4 尖jian1 辈bei4 涉she4 贡gong4 缘yuan2 摩mo2
殊shu1 岳yue4 奋fen4 棉mian2 雕diao1 跃yue4 冒mao4 渡du4 启qi3 阁ge2
患huan4 伏fu2 池chi2 劲jin4 晋jin4 圈quan1 媒mei2 沟gou1 锋feng1 胆dan3
隔ge2 弄nong4 曹cao2 苗miao2 迁qian1 叹tan4 唯wei2 振zhen4 贯guan4 彻che4
祭ji4 符fu2 僧seng1 旋xuan2 凤feng4 黎li2 郎lang2 援yuan2 忌ji4 祥xiang2
董dong3 辛xin1 敏min3 浪lang4 貌mao4 毁hui3 巧qiao3 净jing4 弃qi4 乃nai3
湘xiang1 亩mu3 宏hong2 皆jie1 番fan1 尸shi1 览lan3 恢hui1 绕rao4 趣qu4
晶jing1 魏wei4 伴ban4 绪xu4 舍she4 阅yue4 井jing3 鸿hong2 旦dan4 惯guan4
扎zha1 穷qiong2 堰yan4 递di4 隶li4 厉li4 杜du4 闲xian2 袭xi2 侍shi4
寨zhai4 豪hao2 浮fu2 券quan4 赤chi4 腐fu3 译yi4 氧yang3 戴dai4 邓deng4
煤mei2 牧mu4 孤gu1 诏zhao4 堡bao3 册ce4 锅guo1 柳liu3 阔kuo4 丘qiu1
趋qu1 锦jin3 陶tao2 晓xiao3 蒋jiang3 艇ting3 穴xue2 辆liang4 腾teng2 绘hui4
炎yan2 狂kuang2 泊bo2 扑pu1 哲zhe2 寡gua3 偷tou1 懂dong3 琴qin2 悲bei1
盾dun4 稍shao1 矛mao2 籍ji2 颁ban1 违wei2 亭ting2 眉mei2 屈qu1 曼man4
饰shi4 碎sui4 悉xi1 寄ji4 迟chi2 描miao2 污wu1 辅fu3 魔mo2 鼻bi2
盗dao4 幼you4 冈gang1 肃su4 抚fu3 慈ci2 扶fu2 盆pen2 炼lian4 倘tang3
杰jie2 暂zan4 跨kua4 渔yu2 宾bin1 漫man4 涌yong3 凝ning2 邻lin2 恰qia4
践jian4 顷qing3 赋fu4 悄qiao1 莱lai2 乏fa2 粒li4 逼bi1 傅fu4 葬zang4
燃ran2 挺ting3 耐nai4 犹you2 辉hui1 乳ru3 陪pei2 颇po1 斜xie2 棋qi2
浅qian3 姊zi3 翼yi4 丧sang4 惨can3 俊jun4 袖xiu4 惠hui4 涂tu2 牵qian1
详xiang2 侯hou2 纤xian1 柔rou2 档dang4 糊hu2 岂qi3 跪gui4 拒ju4 覆fu4
吓xia4 揭jie1 赖lai4 卢lu2 娃wa2 颗ke1 邮you2 扇shan4 伐fa2 循xun2
凯kai3 羽yu3 枚mei2 帅shuai4 锁suo3 疏shu1 搭da1 俱ju4 帐zhang4 赫he4
彼bi3 浙zhe4 弯wan1 拱gong3 肿zhong3 膜mo2 杆gan1 凶xiong1 贾jia3 夹jia1
乾qian2 廊lang2 丛cong2 牢lao2 脊ji3 熙xi1 卒zu2 碑bei1 徽hui1 踏ta4
朵duo3 遵zun1 狠hen3 菲fei1 撒sa1 扰rao3 锡xi1 炉lu2 纹wen2 匹pi3
亏kui1 穆mu4 邀yao1 芳fang1 豫yu4 吾wu2 奸jian1 棒bang4 淮huai2 耕geng1
艘sou1 脂zhi1 兽shou4 盈ying2 卵luan3 柴chai2 妃fei1 碍ai4 遂sui4 拨bo1
肌ji1 俘fu2 恒heng2 励li4 鸣ming2 腔qiang1 拦lan2 塑su4 拆chai1 靖jing4
耗hao4 披pi1 胁xie2 吏li4 纽niu3 烂lan4 辟pi4 耶ye1 艰jian1 佩pei4
敦dun1 荐jian4 匠jiang4 柏bai3 悠you1 壤rang3 乔qiao2 妖yao1 掩yan3 璃li2
孟meng4 歇xie1 晨chen2 坊fang1 桑sang1 堤di1 瞎xia1 氨an1 辨bian4 昏hun1
恭gong1 畜chu4 浩hao4 迪di2 窝wo1 洁jie2 奈nai4 肤fu1 砖zhuan1 幽you1
赢ying2 藕ou3 舒shu1 耀yao4 篮lan2 尿niao4 唤huan4 梯ti1 勾gou1 霍huo4
侠xia2 枢shu1 衙ya2 殷yin1 栏lan2 纠jiu1 链lian4 笼long2 寸cun4 冶ye3
弥mi2 哩li5 稿gao3 娜na4 拼pin1 榜bang3 囊nang2 逆ni4 堪kan1 棺guan1
胎tai1 俩lia3 匆cong1 乙yi3 藻zao3 携xie2 函han2 悟wu4 祸huo4 秉bing3
慰wei4 驰chi2 狱yu4 纬wei3 茅mao2 催cui1 踪zong1 叛pan4 浑hun2 牲sheng1
杖zhang4 鞭bian1 腺xian4 邪xie2 欣xin1 汝ru3 碳tan4 彭peng2 椒jiao1 绳sheng2
颈jing3 漆qi1 夷yi2 郁yu4 斑ban1 忆yi4 阀fa2 卑bei1 抑yi4 仔zai3
兆zhao4 庸yong1 疯feng1 斩zhan3 赐ci4 柄bing3 轿jiao4 拓tuo4 扮ban4 砂sha1
辐fu2 玻bo1 昂ang2 圳zhen4 侨qiao2 吟yin2 刃ren4 昨zuo2 浜bang1
冯feng2 艾ai4 捧peng3 袍pao2 溜liu1 坑keng1 串chuan4 押ya1 宅zhai2 逢feng2
扁bian3 丑chou3 趁chen4 妥tuo3 卜bu3 陀tuo2 抹mo3 倡chang4 矩ju3 拐guai3
棍gun4 晕yun1 欠qian4 斋zhai1 丫ya1 涔cen2 戚qi1 硕shuo4 摘zhai1 崖ya2
喇la3 抄chao1 撰zhuan4 凑cou4 赚zhuan4 勋xun1 匾bian3 攀pan1 惹re3 泼po1
坟fen2 宠chong3 涛tao1 掏tao1 哑ya3 巢chao2 焚fen2 乖guai1 潘pan1 歪wai1
鸦ya1 涯ya2 驼tuo2 匪fei3 垄long3 愣leng4 驴lv2 闸zha2 耍shua3 熬ao2
骚sao1 芽ya2 框kuang4 诈zha4 凛lin3 剖pou1 垮kua3 嵌qian4 犬quan3 烘hong1
颊jia2 灿can4 棱leng2 拢long3 奢she1 枉wang3 髓sui3 坠zhui4 甩shuai3 瞅chou3
垒lei3 贬bian3 窜cuan4 胚pei1 芷zhi3 膊bo2 逛guang4 恍huang3 讽feng3 衬chen4
钾jia3 歉qian4 寝qin3 眷juan4 瀛ying2 倦juan4 淤yu1 戳chuo1 搂lou3 挠nao2
莽mang3 魁kui2 谎huang3 尬ga4 梭suo1 涅nie4 撇pie3 凹ao1 朽xiu3 嘲chao2
斐fei3 篷peng2 耿geng3 敞chang3 鞘qiao4 蒿hao1 窍qiao4 拈nian1 灼zhuo2 梗geng3
鳌ao2 酥su1 眨zha3 稼jia4 邹zou1 逵kui2 聂nie4 琛chen1 蔗zhe4 拇mu3
倪ni2 缀zhui4 浊zhuo2 瞥pie1 谬miu4 熏xun1 碾nian3 咧lie3 滔tao1 炯jiong3
唬hu3 峭qiao4 筛shai1 椭tuo3 眯mi1 肘zhou3 孽nie4 樱ying1 榻ta4 憋bie1
鹧zhe4 吭keng1 翘qiao4 乍zha4 酯zhi3 栅zha4 绰chuo4 莹ying2 奎kui2 揣chuai3
绢juan4 茸rong2 烁shuo4 朔shuo4 攒zan3 唾tuo4 蕾lei3 葵kui2 镍nie4 俏qiao4
叭ba1 楞leng4 韬tao1 虐nve4 蒯kuai3 妮ni1 沁qin4 噶ga2 娑suo1 篆zhuan4
嗦suo5 撬qiao4 酌zhuo2 裳shang5 捻nian3 乓pang1 勺shao2 隘ai4 狸li2 伶ling2
讧hong4 嘎ga1 纂zuan3 卯mao3 札zha2 绷beng1 瓮weng4 肋lei4 辇nian3 椰ye1
刨pao2 蕊rui3 褚chu3 匡kuang1 荧ying2 拗ao4 嗔chen1 夔kui2 搀chan1 袄ao3
眩xuan4 橱chu2 馔zhuan4 酣han1 撩liao2 萤ying2 迥jiong3 獾huan1 鹊que4 辍chuo4
唆suo1 堑qian4 颓tui2 哽geng3 篡cuan4 躇chu2 啄zhuo2 雏chu2 甭beng2 炫xuan4
蚣gong1 瘩da5 盎ang4 屉ti4 驮tuo2 噜lu1 夯hang1 湍tuan1 瑛ying1 秤cheng4
幌huang3 窘jiong3 锄chu2 汾fen2 鳖bie1 咪mi1 儡lei3 笋sun3 啷lang1 蛤ha2
掺chan1 莺ying1 迂yu1 呸pei1 喽lou5 搔sao1 辗zhan3 掖ye1 稣su1 楹ying2
蟒mang3 憨han1 赘zhui4 氽tun3 铿keng1 宕dang4 鸾luan2 霓ni2 绚xuan4 妞niu1
岑cen2 瓢piao2 膺ying1 窿long2 韶shao2 筐kuang1 噎ye1 渲xuan4 杵chu3 忖cun3
蔼ai3 挛luan2 沱tuo2 撵nian3 淆xiao2 瘀yu1 讷ne4 笆ba1 亘gen4 镯zhuo2
簪zan1 磊lei3 抠kou1 蹑nie4 肮ang1 峦luan2 怅chang4 擢zhuo2 簸bo3 鲵ni2
嫖piao2 谝pian3 晁chao2 瞟piao3 戛jia2 翡fei3 辏cou4 蹋ta4 抡lun1 焯chao1
疟nve4 鼾han1 吮shun3 咫zhi3 缨ying1 榈lv2 谶chen4 跛bo3 攥zuan4 鹦ying1
篓lou3 匝za1 绠geng3 敖ao2 骈pian2 撅jue1 埙xun1 滦luan2 擞sou3 嗷ao2
踹chuai4 冗rong3 薰xun1 芍shao2 闾lv2 臊sao1 隗wei3 诽fei3 艮gen4 囧jiong3
鳔biao4 庹tuo3 畲she1 铳chong4 嘤ying1 佞ning4 岬jia3 谆zhun1 猬wei4
"""

_WORD_DATA = """
漂亮:piao4,liang4 漂白:piao3,bai2 漂染:piao3,ran3
银行:yin2,hang2 行业:hang2,ye4 行列:hang2,lie4 一行:yi1,hang2 同行:tong2,hang2
分行:fen1,hang2 支行:zhi1,hang2 行家:hang2,jia1 外行:wai4,hang2 内行:nei4,hang2
音乐:yin1,yue4 乐器:yue4,qi4 乐队:yue4,dui4 乐曲:yue4,qu3 乐团:yue4,tuan2
成长:cheng2,zhang3 长大:zhang3,da4 长辈:zhang3,bei4 校长:xiao4,zhang3 市长:shi4,zhang3
部长:bu4,zhang3 省长:sheng3,zhang3 县长:xian4,zhang3 班长:ban1,zhang3 队长:dui4,zhang3
家长:jia1,zhang3 生长:sheng1,zhang3 长官:zhang3,guan1 董事长:dong3,shi4,zhang3 增长:zeng1,zhang3
长相:zhang3,xiang4 重庆:chong2,qing4 重复:chong2,fu4 重新:chong2,xin1 重叠:chong2,die2
重阳:chong2,yang2 还给:huan2,gei3 还款:huan2,kuan3 归还:gui1,huan2 偿还:chang2,huan2
还原:huan2,yuan2 还债:huan2,zhai4 还书:huan2,shu1 睡觉:shui4,jiao4 午觉:wu3,jiao4
教书:jiao1,shu1 教给:jiao1,gei3 头发:tou2,fa4 理发:li3,fa4 发型:fa4,xing2
毛发:mao2,fa4 假发:jia3,fa4 首都:shou3,du1 都市:du1,shi4 成都:cheng2,du1
几乎:ji1,hu1 茶几:cha2,ji1 为了:wei4,le5 因为:yin1,wei4 成为:cheng2,wei2
作为:zuo4,wei2 认为:ren4,wei2 以为:yi3,wei2 行为:xing2,wei2 为主:wei2,zhu3
为人:wei2,ren2 为期:wei2,qi1 一只:yi4,zhi1 只有:zhi3,you3 船只:chuan2,zhi1
干净:gan1,jing4 干燥:gan1,zao4 干杯:gan1,bei1 饼干:bing3,gan1 干涉:gan1,she4
干扰:gan1,rao3 若干:ruo4,gan1 种植:zhong4,zhi2 种地:zhong4,di4 耕种:geng1,zhong4
接种:jie1,zhong4 得到:de2,dao4 觉得:jue2,de5 记得:ji4,de5 值得:zhi2,de5
获得:huo4,de2 显得:xian3,de5 懂得:dong3,de5 得意:de2,yi4 得以:de2,yi3
人参:ren2,shen1 参差:cen1,ci1 地方:di4,fang1 地道:di4,dao5 的确:di2,que4
目的:mu4,di4 打的:da3,di1 似的:shi4,de5 好似:hao3,si4 便宜:pian2,yi5
大便:da4,bian4 方便:fang1,bian4 会计:kuai4,ji4 数数:shu3,shu4 数落:shu3,luo5
无数:wu2,shu4 倒是:dao4,shi4 倒影:dao4,ying3 倒退:dao4,tui4 摔倒:shuai1,dao3
打倒:da3,dao3 跌倒:die1,dao3 处理:chu3,li3 处分:chu3,fen4 处罚:chu3,fa2
相处:xiang1,chu3 处于:chu3,yu2 处在:chu3,zai4 好处:hao3,chu4 到处:dao4,chu4
处处:chu4,chu4 难处:nan2,chu4 调查:diao4,cha2 调动:diao4,dong4 调整:tiao2,zheng3
调节:tiao2,jie2 空调:kong1,tiao2 调皮:tiao2,pi2 强调:qiang2,diao4 声调:sheng1,diao4
曲调:qu3,diao4 歌曲:ge1,qu3 弯曲:wan1,qu1 曲线:qu1,xian4 曲折:qu1,zhe2
答应:da1,ying5 答理:da1,li3 应该:ying1,gai1 应当:ying1,dang1 应用:ying4,yong4
反应:fan3,ying4 适应:shi4,ying4 应付:ying4,fu4 供应:gong1,ying4 相似:xiang1,si4
相声:xiang4,sheng5 照相:zhao4,xiang4 相片:xiang4,pian4 首相:shou3,xiang4 宰相:zai3,xiang4
假期:jia4,qi1 放假:fang4,jia4 请假:qing3,jia4 暑假:shu3,jia4 寒假:han2,jia4
假如:jia3,ru2 假设:jia3,she4 空闲:kong4,xian2 空白:kong4,bai2 填空:tian2,kong4
空隙:kong4,xi4 差不多:cha4,bu5,duo1 差别:cha1,bie2 差异:cha1,yi4 差距:cha1,ju4
出差:chu1,chai1 差点:cha4,dian3 快乐:kuai4,le4 欢乐:huan1,le4 可乐:ke3,le4
娱乐:yu2,le4 了解:liao3,jie3 了不起:liao3,bu5,qi3 了结:liao3,jie2 一目了然:yi2,mu4,liao3,ran2
大夫:dai4,fu5 丈夫:zhang4,fu5 薄荷:bo4,he5 单薄:dan1,bo2 朝阳:zhao1,yang2
朝气:zhao1,qi4 朝代:chao2,dai4 朝鲜:chao2,xian3 新鲜:xin1,xian1 鲜艳:xian1,yan4
鲜花:xian1,hua1 朝向:chao2,xiang4 血液:xue4,ye4 流血:liu2,xue4 献血:xian4,xue4
奔波:ben1,bo1 波浪:bo1,lang4 传记:zhuan4,ji4 传达:chuan2,da2 宣传:xuan1,chuan2
自传:zi4,zhuan4 转动:zhuan4,dong4 旋转:xuan2,zhuan3 转身:zhuan3,shen1 转弯:zhuan3,wan1
转变:zhuan3,bian4 载重:zai4,zhong4 记载:ji4,zai3 刊载:kan1,zai3 三年五载:san1,nian2,wu3,zai3
系鞋带:ji4,xie2,dai4 关系:guan1,xi4 联系:lian2,xi4 系统:xi4,tong3 兴奋:xing1,fen4
兴起:xing1,qi3 兴趣:xing4,qu4 高兴:gao1,xing4 尽管:jin3,guan3 尽量:jin3,liang4
尽快:jin3,kuai4 尽力:jin4,li4 卷子:juan4,zi5 试卷:shi4,juan4 卷起:juan3,qi3
胶卷:jiao1,juan3 塞车:sai1,che1 要塞:yao4,sai4 堵塞:du3,se4 模样:mu2,yang4
模型:mo2,xing2 模范:mo2,fan4 模糊:mo2,hu5 淹没:yan1,mo4 没收:mo4,shou1
埋没:mai2,mo4 埋怨:man2,yuan4 否则:fou3,ze2 是否:shi4,fou3 扁担:bian3,dan4
担子:dan4,zi5 负担:fu4,dan1 担心:dan1,xin1 担任:dan1,ren4 挑战:tiao3,zhan4
挑衅:tiao3,xin4 宁可:ning4,ke3 宁愿:ning4,yuan4 宁肯:ning4,ken3 什么:shen2,me5
什锦:shi2,jin3 个中:ge4,zhong1 中奖:zhong4,jiang3 中毒:zhong4,du2 打中:da3,zhong4
命中:ming4,zhong4 看中:kan4,zhong4 猜中:cai1,zhong4 中意:zhong4,yi4 地壳:di4,qiao4
贝壳:bei4,ke2 弹壳:dan4,ke2 子弹:zi3,dan4 弹簧:tan2,huang2 弹琴:tan2,qin2
弹性:tan2,xing4 炸弹:zha4,dan4 导弹:dao3,dan4 爆炸:bao4,zha4 炸鸡:zha2,ji1
油炸:you2,zha2 喝彩:he4,cai3 喝令:he4,ling4 吆喝:yao1,he5 呵斥:he1,chi4
称心:chen4,xin1 对称:dui4,chen4 称职:chen4,zhi2 匀称:yun2,chen4 盛饭:cheng2,fan4
盛满:cheng2,man3 茂盛:mao4,sheng4 盛开:sheng4,kai1 兴盛:xing1,sheng4 剩下:sheng4,xia4
省会:sheng3,hui4 反省:fan3,xing3 省悟:xing3,wu4 归省:gui1,xing3 角色:jue2,se4
主角:zhu3,jue2 配角:pei4,jue2 角逐:jue2,zhu2 号角:hao4,jiao3 角度:jiao3,du4
缝隙:feng4,xi4 裂缝:lie4,feng4 缝补:feng2,bu3 缝纫:feng2,ren4 宿舍:su4,she4
住宿:zhu4,su4 一宿:yi4,xiu3 星宿:xing1,xiu4 舍不得:she3,bu5,de5 舍弃:she3,qi4
施舍:shi1,she3 恶心:e3,xin1 可恶:ke3,wu4 厌恶:yan4,wu4 恶劣:e4,lie4
凶恶:xiong1,e4 憎恶:zeng1,wu4 散步:san4,bu4 散布:san4,bu4 分散:fen1,san4
散文:san3,wen2 松散:song1,san3 散漫:san3,man4 闷热:men1,re4 纳闷:na4,men4
郁闷:yu4,men4 沉闷:chen2,men4 巷道:hang4,dao4 小巷:xiao3,xiang4 巷子:xiang4,zi5
泊车:bo2,che1 停泊:ting2,bo2 湖泊:hu2,po1 血泊:xue4,po1 累积:lei3,ji1
积累:ji1,lei3 劳累:lao2,lei4 累赘:lei2,zhui4 藏族:zang4,zu2 西藏:xi1,zang4
宝藏:bao3,zang4 躲藏:duo3,cang2 蒙古:meng3,gu3 蒙骗:meng1,pian4 启蒙:qi3,meng2
乘客:cheng2,ke4 千乘:qian1,sheng4 翘首:qiao2,shou3 翘课:qiao4,ke4 翘尾巴:qiao4,wei3,ba5
朴素:pu3,su4 朴实:pu3,shi2 朴刀:po1,dao1 姓朴:xing4,piao2 熟悉:shu2,xi1
成熟:cheng2,shu2 熟练:shu2,lian4 东西:dong1,xi5 西西:xi1,xi1 明白:ming2,bai5
清楚:qing1,chu5 知道:zhi1,dao4 道理:dao4,li3 这个:zhe4,ge5 那个:na4,ge5
哪个:na3,ge5 咱们:zan2,men5 怎么:zen3,me5 这么:zhe4,me5 那么:na4,me5
多么:duo1,me5 时候:shi2,hou5 已经:yi3,jing1 旗袍:qi2,pao2 玩意:wan2,yi4
玩具:wan2,ju4 好奇:hao4,qi2 爱好:ai4,hao4 喜好:xi3,hao4 好学:hao4,xue2
好胜:hao4,sheng4

睡着:shui4,zhao2 着急:zhao2,ji2 着火:zhao2,huo3 着凉:zhao2,liang2
着手:zhuo2,shou3 着陆:zhuo2,lu4 穿着:chuan1,zhuo2 沿着:yan2,zhe5
跟着:gen1,zhe5 接着:jie1,zhe5 供给:gong1,ji3 给予:ji3,yu3 补给:bu3,ji3
脏话:zang1,hua4 肮脏:ang1,zang1 心脏:xin1,zang4 内脏:nei4,zang4
扎实:zha1,shi2 挣扎:zheng1,zha2 包扎:bao1,za1 单于:chan2,yu2
仿佛:fang3,fu2 佛教:fo2,jiao4 佛像:fo2,xiang4 薄荷:bo4,he5
薄弱:bo2,ruo4 刻薄:ke4,bo2 薄片:bao2,pian4 得去:dei3,qu4 得做:dei3,zuo4
还是:hai2,shi4 还有:hai2,you3 行李:xing2,li5 行动:xing2,dong4
银行家:yin2,hang2,jia1 行情:hang2,qing2 排行:pai2,hang2 发行:fa1,xing2
乐意:le4,yi4 乐观:le4,guan1 声乐:sheng1,yue4 乐谱:yue4,pu3
调料:tiao2,liao4 调查员:diao4,cha2,yuan2 音调:yin1,diao4 调整期:tiao2,zheng3,qi1
重量:zhong4,liang4 重心:zhong4,xin1 重建:chong2,jian4 重申:chong2,shen1
重组:chong2,zu3 双重:shuang1,chong2 隆重:long2,zhong4 严重:yan2,zhong4
干活:gan4,huo2 干部:gan4,bu4 能干:neng2,gan4 晒干:shai4,gan1
豆干:dou4,gan1 干预:gan1,yu4 相干:xiang1,gan1 树干:shu4,gan4
长城:chang2,cheng2 长江:chang2,jiang1 特长:te4,chang2 擅长:shan4,chang2
长辈们:zhang3,bei4,men5 年长:nian2,zhang3 长势:zhang3,shi4
数据:shu4,ju4 数学:shu4,xue2 数落人:shu3,luo5,ren2 次数:ci4,shu4
都会:du1,hui4 都城:du1,cheng2 古都:gu3,du1 大都会:da4,du1,hui4
发现:fa1,xian4 发生:fa1,sheng1 理发师:li3,fa4,shi1 染发:ran3,fa4
落下:luo4,xia4 落后:luo4,hou4 丢三落四:diu1,san1,la4,si4 落枕:lao4,zhen3
角落:jiao3,luo4 降落:jiang4,luo4 投降:tou2,xiang2 降服:xiang2,fu2
下降:xia4,jiang4 降低:jiang4,di1 铺路:pu1,lu4 铺垫:pu1,dian4
店铺:dian4,pu4 当铺:dang4,pu4 当时:dang1,shi2 当然:dang1,ran2
当作:dang4,zuo4 上当:shang4,dang4 恰当:qia4,dang4 适当:shi4,dang4
更加:geng4,jia1 更新:geng1,xin1 更换:geng1,huan4
更正:geng1,zheng4 三更:san1,geng1 便当:bian4,dang1 便捷:bian4,jie2
便宜货:pian2,yi5,huo4 大腹便便:da4,fu4,pian2,pian2
强迫:qiang3,po4 勉强:mian3,qiang3 倔强:jue2,jiang4 强大:qiang2,da4
几率:ji1,lv4 窗明几净:chuang1,ming2,ji1,jing4 率领:shuai4,ling3
率先:shuai4,xian1 效率:xiao4,lv4 概率:gai4,lv4 汇率:hui4,lv4
兴致:xing4,zhi4 兴许:xing1,xu3 复兴:fu4,xing1 扫兴:sao3,xing4
尽头:jin4,tou2 尽情:jin4,qing2 尽善尽美:jin4,shan4,jin4,mei3
处女:chu3,nv3 独处:du2,chu3 住处:zhu4,chu4 用处:yong4,chu4
传说:chuan2,shuo1 传统:chuan2,tong3 水浒传:shui3,hu3,zhuan4
名人传:ming2,ren2,zhuan4 空气:kong1,qi4 空间:kong1,jian1
空地:kong4,di4 空缺:kong4,que1 抽空:chou1,kong4 有空:you3,kong4
的士:di1,shi4 目的地:mu4,di4,di4 的确良:di2,que4,liang2
地球:di4,qiu2 土地:tu3,di4 好好地:hao3,hao3,de5 慢慢地:man4,man4,de5
悄悄地:qiao1,qiao1,de5 轻轻地:qing1,qing1,de5
"""


def _parse_chars(raw: str) -> dict:
    table = {}
    for tok in raw.split():
        ch, py = tok[0], tok[1:]
        table.setdefault(ch, py)
    return table


def _parse_words(raw: str) -> dict:
    table = {}
    for tok in raw.split():
        word, readings = tok.split(":", 1)
        table[word] = tuple(readings.split(","))
    return table


CHAR_LEXICON = _parse_chars(_CHAR_DATA)
WORD_LEXICON = _parse_words(_WORD_DATA)
