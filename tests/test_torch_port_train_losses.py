"""The port's training losses against the JAX package's on the CPU, f32,
weights carried by utils.convert: the DVAE's training forward (the
straight-through quantizer, smooth_l1, SSIM, commitment), its EMA codebook
update and balancing heuristic, and the GPT's text and mel cross-entropies,
each with its gradients against jax.grad's.

Tolerances: DVAE recon, ssim and commitment within 1e-5 (relative), codes
identical, the EMA codebook within 1e-6 (relative; atol 1e-7); GPT
loss_text and loss_mel within 1e-5 (relative); every gradient within rtol
1e-4 / atol 1e-6 of jax.grad's. The balancing reset matches JAX's mask and
counts (its fresh values come from another generator)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import DVAEConfig, GPTConfig  # noqa: E402
from xtts_tpu.models import dvae as jdv, gpt as jgpt  # noqa: E402
from xtts_tpu.train import steps as jsteps  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.models import dvae as tdv, gpt as tgpt  # noqa: E402
from xtts_tpu_torch.train import steps as tsteps  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402
from test_torch_port_e2e import one_torch_thread, shaped_zeros  # noqa: E402,F401
from test_torch_port_gpt import randomize  # noqa: E402

MB = 8
DVAES = {
    "upsampled": DVAEConfig(channels=MB, num_tokens=30, hidden_dim=16,
                            num_resnet_blocks=1, codebook_dim=16,
                            num_layers=2),
    "transposed": DVAEConfig(channels=MB, num_tokens=64, hidden_dim=16,
                             num_resnet_blocks=2, codebook_dim=12,
                             num_layers=2, use_transposed_convs=True,
                             activation="silu"),
}
GPT_CFG = GPTConfig(layers=2, model_dim=32, heads=2, max_mel_tokens=24,
                    max_text_tokens=16, number_text_tokens=16,
                    start_text_token=15, number_mel_codes=32,
                    start_mel_token=30, stop_mel_token=31, mel_bins=MB,
                    cond_attn_blocks=1)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dvae(cfg, seed=0):
    jm = jdv.DVAE(cfg)
    init = _np(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((1, MB, 33))))
    jv = {"params": randomize(init["params"], np.random.default_rng(seed)),
          "codebook": init["codebook"]}
    tm = tdv.DVAE(tcfg.DVAEConfig.from_dict(cfg.to_dict()))
    to_sd = lambda t: convert.dvae_from_jax(t, cfg.num_layers,
                                            cfg.num_resnet_blocks)
    tm.load_state_dict(convert.to_torch(to_sd(jv), "cpu"))
    return jm, jv, tm, to_sd


def _grads_close(tm, jgrads, to_sd, cols):
    want = to_sd({"params": _np(jgrads), **cols})
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n], **GRAD,
                                   err_msg=n)


@pytest.mark.parametrize("name", sorted(DVAES))
def test_dvae_loss_codes_codebook_and_grads(name):
    cfg = DVAES[name]
    jm, jv, tm, to_sd = _dvae(cfg)
    # the transposed decoder gives 4 N - 3 frames: 4 M + 1 come back whole
    t = 41 if cfg.use_transposed_convs else 40
    mel = np.random.default_rng(1).standard_normal(
        (3, MB, t)).astype(np.float32)
    jloss = jsteps.make_dvae_loss(jm)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jv["params"], {"codebook": jv["codebook"]}, {"mel": mel},
        jax.random.PRNGKey(0))
    jcodes, jr = jax.jit(lambda v, m: (
        jm.apply(v, m, method=jm.get_codebook_indices),
        jm.apply(v, m, train=False)))(jv, mel)
    tl, taux = tsteps.make_dvae_loss(tm)({"mel": torch.from_numpy(mel)})
    tl.backward()
    for k in ("recon", "ssim", "commitment"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_array_equal(
        tm.get_codebook_indices(torch.from_numpy(mel)).numpy(), jcodes)
    new = taux["new_state_cols"]
    for k, v in _np(jaux["new_state_cols"]["codebook"]).items():
        np.testing.assert_allclose(new["codebook." + k].numpy(), v,
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    _grads_close(tm, jg, to_sd, {"codebook": jv["codebook"]})
    # the forward's recon mel and train=False decode
    tr = tm(torch.from_numpy(mel), train=False)
    np.testing.assert_allclose(tr[3].detach().numpy(), np.asarray(jr[3]),
                               rtol=1e-4, atol=1e-4)


def test_transposed_decoder_state_dict_is_the_references():
    """The transposed-conv DVAE's port state dict carries back to JAX's
    variables through xtts_tpu's dvae_from_reference."""
    from xtts_tpu.utils import convert as jconv
    cfg = DVAES["transposed"]
    _, jv, tm, _ = _dvae(cfg, seed=2)
    back = jconv.dvae_from_reference(
        {k: v.numpy() for k, v in tm.state_dict().items()}, cfg.num_layers,
        cfg.num_resnet_blocks)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jv)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_balancing_mask_and_counts_match():
    """A window small enough to fire on the first batch: the same codes
    reset (embed / embed_avg redrawn, cluster size zeroed), the window
    restarted, and the codes kept unchanged."""
    cfg = DVAES["upsampled"].replace(balancing_heuristic=True,
                                     balance_window=8)
    jm, jv, tm, to_sd = _dvae(cfg, seed=3)
    mel = np.random.default_rng(4).standard_normal(
        (2, MB, 32)).astype(np.float32)
    _, jaux = jax.jit(jsteps.make_dvae_loss(jm))(
        jv["params"], {"codebook": jv["codebook"]}, {"mel": mel},
        jax.random.PRNGKey(5))
    _, taux = tsteps.make_dvae_loss(tm)({"mel": torch.from_numpy(mel)},
                                        torch.Generator().manual_seed(5))
    want = _np(jaux["new_state_cols"]["codebook"])
    got = {k.split(".", 1)[1]: v.numpy()
           for k, v in taux["new_state_cols"].items()}
    assert float(got["bal_total"]) == float(want["bal_total"]) == 0.0
    np.testing.assert_array_equal(got["bal_hist"], want["bal_hist"])
    reset_j = want["cluster_size"] == 0
    reset_t = got["cluster_size"] == 0
    np.testing.assert_array_equal(reset_t, reset_j)
    assert 0 < reset_t.sum() < cfg.num_tokens
    keep = ~reset_t
    np.testing.assert_allclose(got["embed"][:, keep], want["embed"][:, keep],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got["embed"][:, reset_t],
                                  got["embed_avg"][:, reset_t])


@pytest.fixture(scope="module")
def gpt_pair():
    jm = jgpt.UnifiedVoice(GPT_CFG)
    # the compiled init's shapes and key order by tracing alone
    # (randomize redraws every leaf: the same draws)
    init = shaped_zeros(lambda: jm.init(
        jax.random.PRNGKey(1), jnp.zeros((1, MB, 16)),
        jnp.zeros((1, 8), jnp.int32), jnp.array([8]),
        jnp.zeros((1, 8), jnp.int32), jnp.array([8 * 1024])))
    params = randomize(init["params"], np.random.default_rng(1))
    to_sd = lambda t: convert.unified_voice_from_jax(
        t, GPT_CFG.layers, GPT_CFG.cond_attn_blocks)
    djm, djv, dtm, _ = _dvae(DVAES["upsampled"], seed=6)
    # one compiled JAX loss and gradient for every case (the DVAE as an arg)
    jloss = jsteps.make_gpt_loss(jm, djm, djv)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b, fz: jloss(p, {}, b, jax.random.PRNGKey(0), fz),
        has_aux=True))
    return jm, params, to_sd, dtm, lambda b: grad_fn(params, b, jloss.frozen)


@pytest.mark.parametrize("lens", [(8, 5, 16, 9), (3, 8, 4, 16)])
def test_gpt_loss_and_grads(gpt_pair, lens):
    """make_gpt_loss with its frozen DVAE (codes through K3's twin) against
    JAX's, and the port forward's return_logits."""
    jm, params, to_sd, dtm, jgrad = gpt_pair
    rng = np.random.default_rng(7)
    batch = {"cond_mel": rng.standard_normal((2, MB, 20)).astype(np.float32),
             "text": rng.integers(2, 14, (2, 8)).astype(np.int32),
             "text_lengths": np.array(lens[:2], np.int32),
             "mel": rng.standard_normal((2, MB, 64)).astype(np.float32),
             "wav_lengths": np.array([lens[2] * 1024, lens[3] * 1024 - 5],
                                     np.int32)}
    (jl, jaux), jg = jgrad(batch)
    tm = tgpt.UnifiedVoice(tcfg.GPTConfig.from_dict(GPT_CFG.to_dict()))
    tm.load_state_dict(convert.to_torch(to_sd(params), "cpu"))
    tb = {k: (torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v)) for k, v in batch.items()}
    tl, taux = tsteps.make_gpt_loss(tm, dtm.eval())(tb)
    tl.backward()
    for k in ("loss_text", "loss_mel"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _grads_close(tm, jg, to_sd, {})
    assert not any(p.grad is not None for p in dtm.parameters())
    codes = dtm.get_codebook_indices(tb["mel"])
    lt, lm, logits = tm(tb["cond_mel"], tb["text"], tb["text_lengths"], codes,
                        tb["wav_lengths"], return_logits=True)
    assert logits.shape == (2, 16 + 2, GPT_CFG.number_mel_codes)
    np.testing.assert_allclose(float(lm), float(jaux["loss_mel"]), rtol=1e-5)


def test_masked_ce_equal():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32)
    tar = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) < 0.6
    want = float(jgpt.masked_ce(logits, tar, mask))
    got = float(tgpt.masked_ce(torch.from_numpy(logits),
                               torch.from_numpy(tar).long(),
                               torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(tgpt.masked_ce(torch.from_numpy(logits),
                                torch.from_numpy(tar).long(),
                                torch.zeros(3, 7, dtype=torch.bool))) == 0.0
