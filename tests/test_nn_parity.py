"""The in-repo module layer (rslo_tpu/nn.py) against Flax linen.

The model files are imported a second time with ``rslo_tpu.nn`` bound to
``flax.linen``; both versions must build the same variable tree (paths,
shapes, dtypes) and, from the same variables, give the same outputs,
batch statistics and gradients.
"""
import contextlib
import dataclasses
import importlib
import sys

import numpy as np
import pytest

flax_linen = pytest.importorskip("flax.linen")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import rslo_tpu  # noqa: E402
import rslo_tpu.models as models_pkg  # noqa: E402
import rslo_tpu.nn as ournn  # noqa: E402

sys.path.insert(0, "tests")
from test_model import make_example, tiny_cfg  # noqa: E402

_NN_MODULES = ["rslo_tpu.models." + m for m in (
    "semiglobal_bn", "layers", "middle_pillar", "vfe_learned",
    "spatial_group_norm", "attention", "middle_dense", "middle", "net",
    "bev_net")]
_flax_versions: dict = {}


@contextlib.contextmanager
def flax_models():
    """Model modules as written, but on flax.linen (module -> module)."""
    ours = {k: sys.modules[k] for k in _NN_MODULES if k in sys.modules}
    for k in ours:
        del sys.modules[k]
    sys.modules["rslo_tpu.nn"] = flax_linen
    rslo_tpu.nn = flax_linen
    sys.modules.update(_flax_versions)
    try:
        for m in _NN_MODULES:
            _flax_versions[m] = importlib.import_module(m)
        yield _flax_versions
    finally:
        for k in _NN_MODULES:
            sys.modules.pop(k, None)
        sys.modules.update(ours)
        sys.modules["rslo_tpu.nn"] = ournn
        rslo_tpu.nn = ournn
        for k, v in ours.items():
            setattr(models_pkg, k.rsplit(".", 1)[1], v)


def _ours(name):
    return importlib.import_module(name)


def _tree_spec(v):
    return jax.tree.map(lambda x: (x.shape, x.dtype), dict(v))


def _maxdiff(a, b):
    return max(jax.tree.leaves(jax.tree.map(
        lambda x, y: float(jnp.max(jnp.abs(jnp.asarray(x, jnp.float32) -
                                           jnp.asarray(y, jnp.float32)))),
        a, b)), default=0.0)


@pytest.mark.parametrize("middle,remat", [("SparseMiddleCov", True),
                                          ("PillarMiddleCov", False)])
def test_odomnet_matches_flax(middle, remat):
    cfg = tiny_cfg()
    cfg = cfg.replace(middle=dataclasses.replace(
        cfg.middle, name=middle, remat=remat, bn_type="bn"))
    ex = make_example(np.random.default_rng(1), cfg)
    with flax_models() as fm:
        FNet = fm["rslo_tpu.models.net"].OdomNet
        v = FNet(cfg).init(jax.random.PRNGKey(0), ex, train=False)
    Net = _ours("rslo_tpu.models.net").OdomNet
    v_ours = Net(cfg).init(jax.random.PRNGKey(0), ex, train=False)
    assert _tree_spec(v_ours) == _tree_spec(v)

    def run(net):
        def loss(p):
            preds, upd = net.apply({"params": p,
                                    "batch_stats": v["batch_stats"]},
                                   ex, train=True, mutable=["batch_stats"])
            return jnp.sum(preds["odometry"]), (preds, upd)
        (_, (preds, upd)), g = jax.value_and_grad(loss, has_aux=True)(
            v["params"])
        ev = net.apply(v, ex, train=False)
        return preds["odometry"], ev["odometry"], upd, g

    with flax_models():
        ref = run(FNet(cfg))
    got = run(Net(cfg))
    for name, a, b in zip(("train odometry", "eval odometry",
                           "batch stats", "grads"), got, ref):
        assert _maxdiff(a, dict(b) if isinstance(b, dict) else b) == 0.0, \
            name


def test_bev_sync_bn_matches_flax():
    """BEV net with cross-replica BN under shard_map over a 'data'
    axis: same tree, outputs and synced running stats."""
    cfg = tiny_cfg()
    odom = dataclasses.replace(cfg.odom, bn_type="sync_bn")
    pcr = cfg.voxelizer.point_cloud_range
    x = jnp.asarray(np.random.default_rng(2).normal(
        size=(2, 16, 16, 32)).astype(np.float32))
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    def run(Bev, v):
        def f(v, x):
            out, upd = Bev(odom, pcr).apply(v, x, True,
                                            mutable=["batch_stats"])
            return out["odometry"], upd
        return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(), P("data")),
                                     out_specs=(P("data"), P()),
                                     check_vma=False))(v, x)

    with flax_models() as fm:
        FBev = fm["rslo_tpu.models.bev_net"].BEVOdomNet
        v = FBev(odom, pcr).init(jax.random.PRNGKey(0), x[:1], False)
        ref = run(FBev, v)
    Bev = _ours("rslo_tpu.models.bev_net").BEVOdomNet
    assert _tree_spec(Bev(odom, pcr).init(jax.random.PRNGKey(0), x[:1],
                                          False)) == _tree_spec(v)
    got = run(Bev, v)
    assert _maxdiff(got[0], ref[0]) == 0.0
    assert _maxdiff(got[1], dict(ref[1])) == 0.0


def test_dropout_under_rngs():
    """The FC head's dropout: same tree as flax and the same eval output;
    in training the mask follows the 'dropout' rng (init values and rng
    folding are not meant to match flax)."""
    cfg = tiny_cfg()
    odom = dataclasses.replace(cfg.odom, dense_predict=False, dropout=0.5)
    pcr = cfg.voxelizer.point_cloud_range
    x = jnp.asarray(np.random.default_rng(3).normal(
        size=(1, 16, 16, 32)).astype(np.float32))
    with flax_models() as fm:
        FBev = fm["rslo_tpu.models.bev_net"].BEVOdomNet
        v = FBev(odom, pcr).init(jax.random.PRNGKey(0), x, False)
        ref_eval = FBev(odom, pcr).apply(v, x, False)["odometry"]
    Bev = _ours("rslo_tpu.models.bev_net").BEVOdomNet
    net = Bev(odom, pcr)
    assert _tree_spec(net.init(jax.random.PRNGKey(0), x, False)) == \
        _tree_spec(v)
    assert _maxdiff(net.apply(v, x, False)["odometry"], ref_eval) == 0.0

    def train(key):
        out, _ = net.apply(v, x, True, mutable=["batch_stats"],
                           rngs={"dropout": key})
        return np.asarray(out["odometry"])

    a, b = train(jax.random.PRNGKey(1)), train(jax.random.PRNGKey(1))
    c = train(jax.random.PRNGKey(2))
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    assert not np.allclose(a, np.asarray(ref_eval))
