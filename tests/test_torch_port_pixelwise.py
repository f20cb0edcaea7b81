"""Parity of the torch port's per-pixel scorer against the JAX package,
on the CPU: the plain version of kernel K2 ("fused") against JAX's
Pallas kernel (interpret mode) and the equivalence ladder against the
literal reference order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu.models import get_model as jget_model
from wild_visual_navigation_tpu.ops import pixelwise_fused as jfused
from wild_visual_navigation_tpu.ops.pixelwise import pixelwise_score as jscore
from wild_visual_navigation_tpu.utils import confidence_generator as jcg
from wild_visual_navigation_tpu_torch.models.registry import get_model
from wild_visual_navigation_tpu_torch.ops import pixelwise_fused as tfused
from wild_visual_navigation_tpu_torch.ops.pixelwise import pixelwise_map_rows_chunked, pixelwise_score, supports_optimized
from wild_visual_navigation_tpu_torch.utils import confidence_generator as tcg
from wild_visual_navigation_tpu_torch.utils.params import mlp_state_from_jax

D, HP, WP = 32, 8, 8
CFG = {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": D, "hidden_sizes": [64, 32, 1], "reconstruction": True}}


@pytest.fixture(scope="module")
def head():
    jm = jget_model(CFG)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, D))))
    tm = get_model(CFG)
    tm.load_state_dict(mlp_state_from_jax(params))
    feat = np.random.default_rng(1).standard_normal((2, D, HP, WP)).astype(np.float32)
    # confidence statistics at the scale of this head's reconstruction error
    _, reco = jfused.pixelwise_score_fused(params, feat, 56, 56)
    reco = np.asarray(reco)
    jst = jcg.confidence_init()._replace(mean=jnp.float32(reco.mean()), std=jnp.float32(reco.std()))
    tst = tcg.confidence_init()._replace(mean=torch.tensor(float(reco.mean())), std=torch.tensor(float(reco.std())))
    return jm, params, tm, feat, jst, tst


OUT = [(56, 56), (23, 37)]


@pytest.mark.parametrize("out", OUT)
def test_fused_plain_matches_jax_fused(head, out):
    """The plain version of K2 against JAX's Pallas scorer: trav and
    conf within 2e-3 (bf16 hidden activations round at other points),
    reco within 1e-3 relative."""
    jm, params, tm, feat, jst, tst = head
    cfg = jcg.ConfidenceConfig()
    jt, jc = jscore(params, feat, *out, cfg, jst, method="fused")
    tt, tc = pixelwise_score(tm, torch.from_numpy(feat), *out, tcg.ConfidenceConfig(), tst, method="fused")
    assert tt.shape == (2, *out) and tc.shape == (2, *out)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=2e-3)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-3)
    _, jr = jfused.pixelwise_score_fused(params, feat, *out)
    _, tr = tfused.pixelwise_score_fused(tm, torch.from_numpy(feat), *out)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("method", ["fused", "gram", "reference"])
@pytest.mark.parametrize("out", OUT)
def test_methods_match_jax_reference_order(head, method, out):
    """Every method against JAX's literal reference order, within the
    ladder's 0.01 (trav) and 0.02 (conf) of tests/test_models.py."""
    jm, params, tm, feat, jst, tst = head
    jt, jc = jscore(params, feat, *out, jcg.ConfidenceConfig(), jst, optimized=False, mlp=jm)
    tt, tc = pixelwise_score(tm, torch.from_numpy(feat), *out, tcg.ConfidenceConfig(), tst, method=method)
    assert float(np.max(np.abs(tt.numpy() - np.asarray(jt)))) < 0.01
    assert float(np.max(np.abs(tc.numpy() - np.asarray(jc)))) < 0.02


def test_gram_matches_jax_gram(head):
    jm, params, tm, feat, jst, tst = head
    jt, jc = jscore(params, feat, 40, 40, jcg.ConfidenceConfig(), jst, method="gram")
    tt, tc = pixelwise_score(tm, torch.from_numpy(feat), 40, 40, tcg.ConfidenceConfig(), tst, method="gram")
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=2e-3)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-3)


def test_row_tables_and_operands(head):
    for out, inp in [(224, 28), (23, 8), (56, 8), (2, 2)]:
        for a, b in zip(tfused._row_tables(out, inp), jfused._row_tables(out, inp)):
            np.testing.assert_array_equal(a, b)
    _, _, tm, feat, _, _ = head
    ops = tfused.fused_precompute(tm, torch.from_numpy(feat), 23, 37)
    assert ops.hw.shape == (2, HP, 37, 64) and ops.hw.dtype == torch.bfloat16 and ops.hw.is_contiguous()
    assert ops.zsts.shape == (2, HP, 37, 32 + 3) and ops.zsts.dtype == torch.float32
    assert ops.w1t.shape == (32, 64) and ops.gt.shape == (33, 32) and ops.starts.shape == (23,)


@pytest.mark.parametrize("out,inp", [(224, 28), (23, 28), (37, 28), (448, 56), (224, 2)])
def test_row_runs_split_rows_by_patch_row_pair(out, inp):
    """K2's blocks take runs of output rows sharing one pair of patch rows
    (equal starts of the JAX package's _row_tables), at most MAX_RUN rows
    each, covering every row once."""
    starts, _ = jfused._row_tables(out, inp)
    runs = tfused._row_runs(starts)
    assert runs.dtype == np.int32 and runs[0] == 0 and runs[-1] == out
    lengths = np.diff(runs)
    assert (lengths >= 1).all() and (lengths <= tfused.MAX_RUN).all()
    for r0, r1 in zip(runs[:-1], runs[1:]):
        assert (starts[r0:r1] == starts[r0]).all()
    for r in range(1, len(runs) - 1):  # a run ends where starts change, or where it is full
        assert starts[runs[r]] != starts[runs[r] - 1] or lengths[r - 1] == tfused.MAX_RUN
    ops = tfused.fused_precompute(get_model(CFG), torch.zeros(1, D, inp, inp), out, out)
    np.testing.assert_array_equal(ops.runs.numpy(), runs)


def test_row_operands_are_built_once_per_shape():
    """starts, coef and runs depend on the row counts alone: a second frame
    of the same shape reuses the first's tensors, which hold _row_tables'
    values."""
    mlp = get_model(CFG)
    a = tfused.fused_precompute(mlp, torch.zeros(1, D, 8, 8), 56, 40)
    b = tfused.fused_precompute(mlp, torch.ones(2, D, 8, 8), 56, 23)
    assert a.starts is b.starts and a.coef is b.coef and a.runs is b.runs
    starts, coef = jfused._row_tables(56, 8)
    np.testing.assert_array_equal(a.starts.numpy(), starts)
    np.testing.assert_array_equal(a.coef.numpy(), coef)
    np.testing.assert_array_equal(a.runs.numpy(), tfused._row_runs(starts))
    c = tfused.fused_precompute(mlp, torch.zeros(1, D, 8, 8), 57, 40)
    assert c.starts is not a.starts and c.starts.shape == (57,)


def test_structural_gates():
    small = get_model(CFG)
    assert supports_optimized(small) and tfused.supports_fused(small, (1, D, 8, 8), 56, 56)
    assert not tfused.supports_fused(small, (1, D, 1, 8), 56, 56)
    deep = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": D, "hidden_sizes": [16, 16, 8, 1],
                                                              "reconstruction": True}})
    assert supports_optimized(deep) and not tfused.supports_fused(deep, (1, D, 8, 8), 56, 56)
    double = get_model({"name": "DoubleMLP", "double_mlp_cfg": {"input_size": D, "hidden_sizes": [16, 1]}})
    assert not supports_optimized(double)


def test_deep_head_takes_gram(head):
    """A four-layer head fails K2's structural test and is scored by "gram"."""
    cfg = {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": D, "hidden_sizes": [48, 32, 16, 1],
                                                   "reconstruction": True}}
    jm = jget_model(cfg)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3), jnp.zeros((1, D))))
    tm = get_model(cfg)
    tm.load_state_dict(mlp_state_from_jax(params))
    _, _, _, feat, jst, tst = head
    jt, _ = jscore(params, feat, 30, 30, jcg.ConfidenceConfig(), jst, optimized=False, mlp=jm)
    tt, _ = pixelwise_score(tm, torch.from_numpy(feat), 30, 30, tcg.ConfidenceConfig(), tst)
    assert float(np.max(np.abs(tt.numpy() - np.asarray(jt)))) < 0.01


def test_rows_chunked_matches_dense_order():
    feat = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 6, 5, 7)).astype(np.float32))
    from wild_visual_navigation_tpu_torch.ops.resize import interpolate_bilinear_mxu

    rows = interpolate_bilinear_mxu(feat, 23, 37)[0].reshape(6, -1).T
    a, b = pixelwise_map_rows_chunked(lambda r: (r.sum(-1), torch.tanh(r[:, 0])), feat, 23, 37, target_rows=8)
    torch.testing.assert_close(a, rows.sum(-1).reshape(23, 37), atol=1e-5, rtol=0)
    torch.testing.assert_close(b, torch.tanh(rows[:, 0]).reshape(23, 37), atol=1e-5, rtol=0)
