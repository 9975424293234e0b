"""Chamfer NN search: scan vs brute-force oracle vs Pallas (interpret)."""
import numpy as np
import jax.numpy as jnp
import pytest

from rslo_tpu.ops import chamfer
from rslo_tpu.ops.chamfer import nn_search, nn_search_pallas


def brute(src, tgt, tgt_mask):
    d = ((src[:, None, :] - tgt[None]) ** 2).sum(-1)
    d[:, ~tgt_mask] = np.inf
    return d.min(1), d.argmin(1)   # argmin returns the first minimum


def test_nn_search_matches_oracle(rng):
    src = rng.normal(size=(300, 3)).astype(np.float32) * 10
    tgt = rng.normal(size=(500, 3)).astype(np.float32) * 10
    sm = np.ones(300, bool)
    sm[250:] = False
    tm = np.ones(500, bool)
    tm[400:] = False
    d, i = nn_search(jnp.asarray(src), jnp.asarray(sm),
                     jnp.asarray(tgt), jnp.asarray(tm), tile=128)
    d, i = np.asarray(d), np.asarray(i)
    od, oi = brute(src, tgt, tm)
    np.testing.assert_array_equal(i[sm], oi[sm])
    np.testing.assert_allclose(d[sm], od[sm], rtol=1e-3, atol=1e-3)
    assert np.all(d[~sm] >= 1e29)


def _case(rng, name):
    """(src, src_mask, tgt, tgt_mask) for one kernel test case.  Every
    case spans several source blocks and target tiles of the kernel."""
    N, M = (256, 256) if name == "aligned" else (203, 157)
    src = rng.normal(size=(N, 3)).astype(np.float32) * 5
    tgt = rng.normal(size=(M, 3)).astype(np.float32) * 5
    sm = np.ones(N, bool)
    sm[-13:] = False
    tm = np.ones(M, bool)
    if name == "masked":
        tm[rng.random(M) < 0.3] = False
    elif name == "all_invalid":
        tm[:] = False
    elif name == "duplicates":
        # every target appears three times (in different tiles), and
        # some sources sit exactly on a target: ties -> first index
        tgt = np.concatenate([tgt[:60]] * 3 + [tgt[:2]])
        tm = np.ones(len(tgt), bool)
        src[:20] = tgt[5:25]
    return src, sm, tgt, tm


@pytest.mark.parametrize("name", ["aligned", "misaligned", "masked",
                                  "all_invalid", "duplicates"])
def test_pallas_kernel_interpret_matches_scan(rng, name):
    """The GPU kernel, run by the Pallas interpreter on the CPU, against
    the XLA scan and a float64 numpy oracle (first index on ties)."""
    src, sm, tgt, tm = _case(rng, name)
    args = [jnp.asarray(a) for a in (src, sm, tgt, tm)]
    d1, i1 = nn_search(*args, tile=64)
    assert len(tgt) > 2 * chamfer.TGT_BLOCK and len(src) > chamfer.SRC_BLOCK
    d2, i2 = nn_search_pallas(*args, interpret=True)
    d2, i2 = np.asarray(d2), np.asarray(i2)
    np.testing.assert_array_equal(i2, np.asarray(i1))
    if not tm.any():
        assert np.all(d2 >= 1e29) and np.all(i2 == 0)
        return
    od, oi = brute(src.astype(np.float64), tgt.astype(np.float64), tm)
    np.testing.assert_array_equal(i2[sm], oi[sm])   # argmin: first index
    np.testing.assert_allclose(d2[sm], od[sm], rtol=1e-5, atol=1e-5)
    assert np.all(d2[~sm] >= 1e29) and np.all(i2[~sm] == 0)


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_nn_search_auto_choice(monkeypatch, platform):
    """The kernel on the GPU, the XLA scan elsewhere; the kernel is
    never asked for interpret mode."""
    calls = []

    def fake_kernel(*a, **kw):
        calls.append(("kernel", kw))
        return nn_search(*a)

    def fake_scan(*a, **kw):
        calls.append(("scan", kw))
        return nn_search.__wrapped__(*a)

    monkeypatch.setattr(chamfer, "_platform", lambda: platform)
    monkeypatch.setattr(chamfer, "nn_search_pallas", fake_kernel)
    monkeypatch.setattr(chamfer, "nn_search", fake_scan)
    x = jnp.zeros((8, 3))
    m = jnp.ones((8,), bool)
    chamfer.nn_search_auto(x, m, x, m)
    assert calls == [("kernel" if platform == "gpu" else "scan", {})]


def test_platform_follows_default_device():
    import jax
    assert chamfer._platform() == "cpu"
    with jax.default_device(jax.devices("cpu")[0]):
        assert chamfer._platform() == "cpu"
