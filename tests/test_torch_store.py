"""The port's in-memory PosteriorStore against the JAX package's: the same
writes give the same rows, generations, blocks and gathers (bitwise:
both keep float64 host blocks), and evict/recycle behaves the same."""
import numpy as np
import pytest

from repro.store import PosteriorStore as JStore
from repro_torch.store import PosteriorStore as TStore
from repro_torch.store import TaskKey

LEAF_SHAPES = {"mu": (2,), "sigma": (2, 2), "beta_prec": (), "x_mu": (),
               "x_sd": (), "y_mu": (), "y_sd": (), "n": ()}


def _rows(rng, n, tenant):
    return [(f"{tenant}/wf/task{i}",
             {k: rng.normal(size=s) for k, s in LEAF_SHAPES.items()})
            for i in range(n)]


@pytest.mark.parametrize("block_size,n", [(4, 10), (512, 300), (7, 64)])
def test_store_writes_gathers_and_evicts_like_reference(block_size, n):
    rng = np.random.default_rng(block_size + n)
    stores = [JStore(block_size), TStore(block_size)]
    a, b = _rows(rng, n, "t0"), _rows(rng, n // 2, "t1")
    for s in stores:
        s.put_many(a)
        s.put_many(b)
        s.put(a[0][0], b[0][1])                  # overwrite one row
    keys = [k for k, _ in a + b]
    order = list(np.random.default_rng(0).permutation(keys))
    for s in stores[1:]:
        assert (s.generation, s.num_blocks, len(s)) == \
            (stores[0].generation, stores[0].num_blocks, len(stores[0]))
        got, want = s.gather(order), stores[0].gather(order)
        assert set(got) == set(want)
        for leaf in want:
            assert np.array_equal(got[leaf], want[leaf]), leaf
    snaps = [s.snapshot() for s in stores]
    assert [s.evict("t0", "wf") for s in stores] == [n, n]
    c = _rows(rng, 3, "t2")
    for s in stores:
        s.put_many(c)                            # recycles freed slots
    for s, old in zip(stores[1:], snaps[1:]):
        assert (s.generation, s.num_free_blocks) == \
            (stores[0].generation, stores[0].num_free_blocks)
        assert s.snapshot().row_of(c[2][0]) == \
            stores[0].snapshot().row_of(c[2][0])
        assert a[1][0] in old and a[1][0] not in s.snapshot()
        with pytest.raises(KeyError):
            s.gather([a[1][0]])


def test_store_rejects_malformed_rows_atomically():
    s = TStore()
    good = {k: np.zeros(v) for k, v in LEAF_SHAPES.items()}
    bad = dict(good, mu=np.zeros(3))
    with pytest.raises(ValueError):
        s.put_many([("t/w/a", good), ("t/w/b", bad)])
    assert (len(s), s.generation) == (0, 0)
    with pytest.raises(ValueError):
        s.put("not-a-key", good)
    with pytest.raises(ValueError):
        TaskKey("t", "w", "a/b")
