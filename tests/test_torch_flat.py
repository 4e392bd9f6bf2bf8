"""The port's ``FlatSpec`` against the JAX ``FlatSpec``: the same tree
gives the same flat row bit for bit, ``unravel`` / ``unravel_row`` give
views, and lossy layouts are rejected with the reference's messages
(``tests/test_flat.py`` is the checklist)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import reduce_for_smoke as j_reduce
from repro.dist.flat import FlatSpec as JFlatSpec
from repro.models.model import init_params as j_init_params
from repro_torch.dist.flat import LANE, FlatSpec, tree_flatten
from repro_torch.models.convert import tree_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep each xdist worker's intra-op pool small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _mixed_tree(batch=4, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(batch, 3, 5)).astype(np.float32),
        "b": np.asarray(jnp.asarray(rng.normal(size=(batch, 7)).astype(np.float32)
                                    ).astype(jnp.bfloat16)),
        "nest": {"s": rng.normal(size=(batch,)).astype(np.float16)},
    }


def _stacked_params(arch, batch=2):
    cfg = j_reduce(J_REGISTRY[arch])
    rows = [jax.tree.map(np.asarray, j_init_params(cfg, jax.random.PRNGKey(i)))
            for i in range(batch)]
    return jax.tree.map(lambda *ls: np.stack(ls), *rows)


TREES = {
    "llama3.2-3b": lambda: _stacked_params("llama3.2-3b"),
    "qwen3-4b": lambda: _stacked_params("qwen3-4b"),
    "mixed": _mixed_tree,
}


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("name", sorted(TREES))
def test_row_is_the_reference_row_bit_for_bit(name):
    tree = TREES[name]()
    jspec = JFlatSpec.for_tree(jax.tree.map(jnp.asarray, tree))
    jbuf = np.asarray(jspec.ravel(jax.tree.map(jnp.asarray, tree)))
    spec = FlatSpec.for_tree(tree_from_numpy(tree))
    buf = spec.ravel(tree_from_numpy(tree))
    assert (spec.offsets, spec.sizes, spec.size, spec.batch) == (
        jspec.offsets, jspec.sizes, jspec.size, jspec.batch)
    np.testing.assert_array_equal(_bits(buf.numpy()), _bits(jbuf))
    # the inverse gives every leaf back exactly, dtypes kept
    for got, want in zip(tree_flatten(spec.unravel(buf))[0], jax.tree.leaves(tree)):
        assert str(got.dtype).split(".")[1] == str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_offsets_lane_aligned_and_padding_zero():
    tree = tree_from_numpy(_mixed_tree())
    spec = FlatSpec.for_tree(tree)
    assert all(o % LANE == 0 for o in spec.offsets) and spec.size % LANE == 0
    out = torch.full((spec.batch, spec.size), 7.0)
    spec.ravel(tree, out=out)
    for off, size, nxt in zip(spec.offsets, spec.sizes,
                              spec.offsets[1:] + (spec.size,)):
        assert not out[:, off + size:nxt].any()


def test_unravel_and_unravel_row_give_views():
    """f32 leaves come back as views of the buffer (writes land in it);
    leaves of another dtype as cast copies."""
    tree = tree_from_numpy(_mixed_tree())
    spec = FlatSpec.for_tree(tree)
    buf = spec.ravel(tree)
    back = spec.unravel(buf)
    back["w"][1, 2, 3] = 42.0
    assert buf[1, spec.offsets[2] + 2 * 5 + 3] == 42.0      # leaves: b, s, w
    assert back["b"].dtype == torch.bfloat16
    row = spec.unravel_row(buf[1])
    assert row["w"].data_ptr() == buf[1, spec.offsets[2]:].data_ptr()
    assert row["w"][2, 3] == 42.0 and row["w"].shape == (3, 5)
    assert row["nest"]["s"].dtype == torch.float16 and row["nest"]["s"].shape == ()


def test_ravel_into_a_resident_buffer_skips_its_own_views():
    tree = tree_from_numpy(_mixed_tree())
    spec = FlatSpec.for_tree(tree)
    buf = spec.ravel(tree)
    ptr = buf.data_ptr()
    views = spec.unravel(buf)
    views["w"].mul_(2.0)
    views["b"] = views["b"] * 2                  # a copy: written back
    assert spec.ravel(views, out=buf).data_ptr() == ptr
    np.testing.assert_array_equal(spec.unravel(buf)["w"].numpy(),
                                  2 * tree["w"].numpy())
    np.testing.assert_array_equal(spec.unravel(buf)["b"].float().numpy(),
                                  2 * tree["b"].float().numpy())


@pytest.mark.parametrize("case", ["int", "narrow", "ragged", "empty", "shape"])
def test_rejects_lossy_or_ragged_layouts(case):
    """The reference's checks and messages (tests/test_flat.py:83)."""
    match = {"int": "losslessly", "narrow": "losslessly",
             "ragged": "leading batch", "empty": "empty",
             "shape": "buffer shape"}[case]
    with pytest.raises(ValueError, match=match):
        if case == "int":
            FlatSpec.for_tree({"x": torch.zeros((2, 3), dtype=torch.int32)})
        elif case == "narrow":
            FlatSpec.for_tree({"x": torch.zeros((2, 3))}, dtype=torch.bfloat16)
        elif case == "ragged":
            FlatSpec.for_tree({"x": torch.zeros((2, 3)), "y": torch.zeros((4, 3))})
        elif case == "empty":
            FlatSpec.for_tree({})
        else:
            FlatSpec.for_tree({"x": torch.zeros((2, 3))}).unravel(torch.zeros((3, 128)))
