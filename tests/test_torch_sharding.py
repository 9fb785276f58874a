"""The port's sharding rules (`repro_torch.distributed.sharding`) against
the reference's (`repro.distributed.sharding`), leaf by leaf, for every
arch of ``configs/`` at full size, with no ranks: the shapes are
``device="meta"`` tensors on the port's side and ``eval_shape`` on the
reference's, and a stand-in carrying a mesh's ``shape`` and
``axis_names`` is all either rule function reads.  Also the local boxes
that the placements give, against DTensor's own offsets and a numpy
slicing of the spec, and the meta shape tables against the reference's."""
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402
from torch.distributed.tensor import Shard  # noqa: E402
from torch.distributed.tensor import _utils as dt_utils  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import SHAPES  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

MESHES = {
    "pod": tmesh.production_mesh_shape(),
    "multi_pod": tmesh.production_mesh_shape(multi_pod=True),
    "local": ((2, 4), ("data", "model")),
}


def _stand_in(shape, names):
    return SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)


@pytest.fixture
def spec_only(monkeypatch):
    """The reference's cache and batch rules wrap each spec in a
    ``NamedSharding``, which needs real devices: keep the spec only."""
    monkeypatch.setattr(jshd, "NamedSharding",
                        lambda mesh, spec: SimpleNamespace(spec=spec))


def _norm(pspec, rank):
    """A reference PartitionSpec as the port's per-dim tuple."""
    out = []
    for e in tuple(pspec) + (None,) * (rank - len(tuple(pspec))):
        out.append(None if e is None else ((e,) if isinstance(e, str)
                                           else tuple(e)))
    return tuple(out)


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jshd._path_names(p): leaf for p, leaf in flat}


def _port_leaves(tree):
    out = {}
    shd.map_with_names(lambda names, leaf: out.__setitem__(names, leaf),
                       tree)
    return out


@pytest.fixture(scope="module")
def shapes():
    """(reference param shapes, port param shapes) for every arch."""
    out = {}
    for name in jconfigs.ARCH_IDS:
        ref = jmodel.Model(jconfigs.get_config(name)).param_shapes()
        port = Model(tconfigs.get_config(name), device="meta").param_shapes()
        out[name] = (_ref_leaves(ref), _port_leaves(port))
    return out


def test_mesh_module_is_data_only():
    assert tmesh.PRODUCTION_MESHES["pod"] == ((16, 16), ("data", "model"))
    assert tmesh.PRODUCTION_MESHES["multi_pod"] == (
        (2, 16, 16), ("pod", "data", "model"))
    assert tmesh.PEAK_FLOPS_BF16 == 989e12 and tmesh.HBM_BW == 3.35e12


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_shapes_match_reference(shapes, arch):
    ref, port = shapes[arch]
    assert ref.keys() == port.keys()
    for k, leaf in port.items():
        assert leaf.device.type == "meta", k
        assert tuple(leaf.shape) == tuple(ref[k].shape), k
        assert str(leaf.dtype).split(".")[-1] == str(ref[k].dtype), k


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_specs_equal_reference(shapes, arch, mesh):
    shape, names = MESHES[mesh]
    stand = _stand_in(shape, names)
    ref, port = shapes[arch]
    cfg = tconfigs.get_config(arch)
    got = shd.param_shardings(cfg, Model(cfg, device="meta").param_shapes(),
                              stand)
    got = _port_leaves(got)
    for k, leaf in ref.items():
        want = _norm(jshd._leaf_spec(k, leaf.shape, stand), len(leaf.shape))
        assert got[k].spec == want, (k, got[k].spec, want)
        assert shd.leaf_spec(k, port[k].shape, stand) == want, k


def _decode_shape():
    return next(s for s in SHAPES if s.kind == "decode"
                and s.name == "decode_32k")


@pytest.mark.parametrize("kv_shard", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_cache_specs_equal_reference(arch, mesh, kv_shard, spec_only):
    shape, names = MESHES[mesh]
    stand = _stand_in(shape, names)
    dec = _decode_shape()
    jcfg = jconfigs.get_config(arch).replace(decode_kv_shard=kv_shard)
    tcfg = tconfigs.get_config(arch).replace(decode_kv_shard=kv_shard)
    ref = jmodel.Model(jcfg).cache_shapes(dec.global_batch, dec.seq_len)
    port = Model(tcfg, device="meta").cache_shapes(dec.global_batch,
                                                   dec.seq_len)
    want = {k: (leaf, _norm(s.spec, len(leaf.shape))) for (k, leaf), s in zip(
        _ref_leaves(ref).items(),
        jax.tree.leaves(jshd.cache_shardings(jcfg, ref, stand)))}
    got = _port_leaves(shd.cache_shardings(tcfg, port, stand))
    leaves = _port_leaves(port)
    assert got.keys() == want.keys()
    for k, (leaf, spec) in want.items():
        assert tuple(leaves[k].shape) == tuple(leaf.shape), k
        assert str(leaves[k].dtype).split(".")[-1] == str(leaf.dtype), k
        assert got[k].spec == spec, (k, got[k].spec, spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_batch_specs_and_input_specs_equal_reference(arch, mesh,
                                                     spec_only):
    shape, names = MESHES[mesh]
    stand = _stand_in(shape, names)
    jm = jmodel.Model(jconfigs.get_config(arch))
    tm = Model(tconfigs.get_config(arch), device="meta")
    for s in SHAPES:
        ref = jm.input_specs(s)
        port = tm.input_specs(ShapeSpec(s.name, s.seq_len, s.global_batch,
                                        s.kind))
        assert ref.keys() == port.keys(), s.name
        want = jshd.batch_shardings(None, ref, stand)
        got = shd.batch_shardings(None, port, stand)
        for k in ref:
            assert tuple(port[k].shape) == tuple(ref[k].shape), (s.name, k)
            assert str(port[k].dtype).split(".")[-1] == str(ref[k].dtype)
            assert port[k].device.type == "meta"
            assert got[k].spec == _norm(want[k].spec, len(ref[k].shape))


SPECS = [
    (("data",), ("model",)),
    (("model",), None),
    (None, ("data", "model")),
    (("pod", "data"), ("model",)),
    ((("pod", "data", "model")), None),
    (None, None),
]


def _numpy_box(shape, spec, sizes, coord):
    """The reference layout by reshaping: a dim over axes (a, b) is viewed
    as [size_a, size_b, chunk] and indexed [coord_a, coord_b]."""
    idx = np.arange(int(np.prod(shape))).reshape(shape)
    for d, axes in enumerate(spec):
        if not axes:
            continue
        split = [sizes[a] for a in axes]
        n = int(np.prod(split))
        view = np.moveaxis(idx, d, 0)
        view = view.reshape(*split, shape[d] // n, *view.shape[1:])
        view = view[tuple(coord[a] for a in axes)]
        idx = np.moveaxis(view, 0, d)
    return idx


@pytest.mark.parametrize("mesh", [((2, 4), ("data", "model")),
                                  ((2, 2, 2), ("pod", "data", "model"))])
def test_local_boxes_from_placements(mesh):
    mshape, names = mesh
    sizes = dict(zip(names, mshape))
    shape = (16, 24)
    for spec in SPECS:
        if any(a not in names for axes in spec if axes for a in axes):
            continue
        placements = shd.to_placements(spec, sizes)
        full = np.arange(int(np.prod(shape))).reshape(shape)
        for c in itertools.product(*(range(n) for n in mshape)):
            coord = dict(zip(names, c))
            box = shd.local_box(shape, spec, sizes, coord)
            want = _numpy_box(shape, spec, sizes, coord)
            np.testing.assert_array_equal(full[box], want)
            # DTensor's own reading of the placements
            lshape, offset = dt_utils._compute_local_shape_and_global_offset(
                shape, mshape, lambda i: c[i], placements)
            assert lshape == full[box].shape, (spec, c)
            assert offset == tuple(b.start or 0 for b in box), (spec, c)


def test_pod_major_split_takes_shard_on_both_mesh_dims():
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert shd.to_placements((("pod", "data"), ("model",)), sizes) == (
        Shard(0), Shard(0), Shard(1))


def test_meta_shapes_allocate_nothing():
    cfg = tconfigs.get_config("dbrx-132b")
    m = Model(cfg, device="meta")
    leaves = _port_leaves(m.param_shapes())
    assert sum(v.numel() for v in leaves.values()) > 1e11
    assert all(v.device.type == "meta" for v in leaves.values())
    cache = _port_leaves(m.cache_shapes(128, 32768))
    assert all(v.device.type == "meta" for v in cache.values())
    assert torch.empty(0).device.type == "cpu"
