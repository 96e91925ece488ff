"""The port's text frontend (xtts_tpu_torch.text, its own copy) against the
JAX package's (xtts_tpu.text): identical framed token arrays and sentence
splits on Mandarin, English and number text. Exact equality."""
import numpy as np
import pytest

from xtts_tpu.text import frontend as jfe
from xtts_tpu_torch.text import frontend as tfe

SENTENCES = [
    "你好，世界。",
    "今天天气真好，我们去公园散步吧！",
    "他在2023年5月12日下午3点15分到达北京。",
    "这件衣服打八五折，只要￥129.50元。",
    "请拨打13812345678联系我。",
    "气温是-3.5°C，湿度百分之六十。",
    "我一个人去了一趟上海，不太顺利。",
    "Hello world, this is a test.",
    "The price is 42 dollars and 7 cents.",
    "我们用GPU和TPU训练了3个模型。",
]


@pytest.mark.parametrize("i", range(len(SENTENCES)))
def test_tokens_identical(i):
    s = SENTENCES[i]
    lang = "EN" if s[0].isascii() else "ZH"
    want = jfe.sentence_to_tokens(s, lang, start_token=255, stop_token=1)
    got = tfe.sentence_to_tokens(s, lang, start_token=255, stop_token=1)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_sentence_split_identical():
    text = "".join(SENTENCES[:7]) + "第八句没有标点"
    assert tfe.split_sentences(text) == jfe.split_sentences(text)


def test_oov_accounting_is_the_ports_own():
    from xtts_tpu.text import chinese as jzh
    from xtts_tpu_torch.text import chinese as tzh
    assert tzh.oov_stats is not jzh.oov_stats
    assert isinstance(tzh.oov_stats(), dict)
