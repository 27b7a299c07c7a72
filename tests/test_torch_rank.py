"""The upward-rank kernel's launch choice and its tables, on the CPU.

  * `rank_config` is a pure function of the largest lane's T, E and L, N,
    B, the card's opt-in shared memory and SM count, and the tables'
    alignment: the shared route at the replan shape (a cluster of 8 at one
    lane, a worker's share of W's rows in one tile), fewer blocks a
    cluster as B grows, balanced tiles at an odd stride when a share does
    not fit, room for the leader's row descriptors, and the global route
    just past the limit or for misaligned tables.
  * A `RankTable` is checked once where it is built or moved; the wrapper
    then checks W against it.

No JAX: these are the port's own launch rules."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decision_plane as dp
from repro_torch.kernels import ref

OPTIN = 232_448            # an H100's opt-in shared memory a block
SMS = 132
REPLAN = dict(t=1000, e=3000, l=27, n=100)


def _config(b=1, optin=OPTIN, sms=SMS, aligned=True, cluster=None, **kw):
    shape = dict(REPLAN, **kw)
    return dp.rank_config(shape["t"], shape["e"], shape["l"], shape["n"], b,
                          optin, sms, aligned=aligned, cluster=cluster)


def test_rank_config_shared_route_at_the_replan_shape():
    cfg = _config()
    layout = dp.rank_layout(1000, 3000, 27)
    # head, rank and avg_comm, succ_ptr, level_ptr, level_rows, succ_idx
    assert layout == (128, 8128, 16128, 20144, 20256, 24256, 36256)
    tab = layout[-1]
    # seven workers of 143 rows (the leader sums none)
    assert cfg == dict(route="shared", cluster=8, tile_rows=143,
                       tables_bytes=tab, layout=layout,
                       smem_bytes=tab + 8 * 100 * 143)


@pytest.mark.parametrize("t,e,l", [(0, 0, 0), (1, 0, 1), (7, 5, 3),
                                   (1000, 3000, 27), (3000, 75_000, 300)])
def test_rank_layout_offsets_are_aligned_and_hold_each_table(t, e, l):
    layout = dp.rank_layout(t, e, l)
    assert len(layout) == 7 and layout[0] == 128
    assert all(off % 16 == 0 for off in layout)
    # rank, avg_comm, succ_ptr, level_ptr, level_rows, succ_idx in turn,
    # each with room for its entries and less than 16 bytes of padding
    for lo, hi, nbytes in zip(layout, layout[1:], (8 * t, 8 * t,
                                                    4 * (t + 1), 4 * (l + 1),
                                                    4 * t, 4 * e)):
        assert nbytes <= hi - lo < nbytes + 16


@pytest.mark.parametrize("b,cluster", [
    (1, 8), (6, 8), (16, 8), (17, 4), (32, 4), (33, 4), (34, 2), (66, 2),
    (67, 1), (500, 1)])
def test_rank_config_cluster_shrinks_as_lanes_grow(b, cluster):
    cfg = _config(b=b)
    assert cfg["route"] == "shared" and cfg["cluster"] == cluster
    assert b * cfg["cluster"] <= SMS or cfg["cluster"] == 1
    rows = -(-1000 // max(cluster - 1, 1))   # a worker's share of the rows
    tiles = -(-rows // cfg["tile_rows"])
    assert cfg["tile_rows"] * tiles >= rows > cfg["tile_rows"] * (tiles - 1)
    assert cfg["smem_bytes"] <= OPTIN
    assert cfg["smem_bytes"] == (cfg["tables_bytes"]
                                 + 8 * 100 * (cfg["tile_rows"] | 1))


def test_rank_config_balances_tiles_that_do_not_fit_at_once():
    # 32 lanes: a cluster of 4, 334 rows for each of 3 workers; 245 fit
    # beside the tables, so two tiles of 167 rows
    cfg = _config(b=32)
    assert (cfg["cluster"], cfg["tile_rows"]) == (4, 167)
    # a small card: every block walks many tiles of an odd stride
    small = _config(optin=64_000)
    cap = (64_000 - small["tables_bytes"]) // 800
    assert small["route"] == "shared"
    assert (small["tile_rows"] | 1) <= cap
    assert small["smem_bytes"] <= 64_000


def test_rank_config_global_route_past_the_limit_or_misaligned():
    tab = dp.rank_layout(1000, 3000, 27)[-1]
    # the tables and the row descriptors fill the limit exactly: still
    # shared, W a few rows a tile
    described = 24 * 1000
    edge = _config(optin=tab + described)
    assert edge["route"] == "shared" and edge["tile_rows"] == 29
    assert edge["smem_bytes"] == tab + described
    # 16 more edges' bytes past it: global
    past = _config(e=3004, optin=tab + described)
    assert dp.rank_layout(1000, 3004, 27)[-1] == tab + 16
    assert past == dict(route="global", cluster=1, tile_rows=0,
                        tables_bytes=0, layout=None, smem_bytes=8000)
    # wide rows: the tables and the descriptors fit, not one W row
    assert _config(n=3100, optin=tab + described)["route"] == "global"
    # a lane whose tables alone overflow the card (T = 9,000, E = 27,000)
    big = _config(t=9000, e=27_000, l=40)
    assert big["route"] == "global" and big["smem_bytes"] == 72_000
    # ranks that do not fit either: the global route keeps them in the
    # output row
    assert _config(t=40_000, e=0, l=1)["smem_bytes"] == 0
    # misaligned tables: global at any size
    assert _config(aligned=False)["route"] == "global"


def test_rank_config_edges_and_cluster_override():
    assert _config(cluster=16)["cluster"] == 16
    # a cluster of one: the leader sums all 1000 rows, in 5 tiles
    assert _config(b=32, cluster=1)["tile_rows"] == 200
    assert _config(cluster=2)["tile_rows"] == 200
    with pytest.raises(ValueError, match="cluster"):
        _config(cluster=3)
    # no W to stage: the leader's row descriptors set the size
    empty = _config(n=0)
    assert empty["route"] == "shared" and empty["smem_bytes"] == \
        empty["tables_bytes"] + 24 * 1000
    none = _config(t=0, e=0, l=0)
    assert none["route"] == "shared" and none["tile_rows"] == 1


def _table(rng, t):
    succ = [sorted({int(s) for s in rng.integers(i + 1, t, 2)})
            if i < t - 1 else [] for i in range(t)]
    return dp.rank_table(succ, rng.uniform(0.0, 2.0, t))


def test_rank_table_is_checked_once_where_built_or_moved():
    tab = _table(np.random.default_rng(0), 12)
    assert (tab.T, tab.L, tab.device) == (12, tab.level_ptr.shape[0] - 1,
                                           torch.device("cpu"))
    assert tab.E == tab.succ_idx.shape[0] == int(tab.succ_ptr[-1])
    moved = tab.to("cpu")
    assert isinstance(moved, dp.RankTable) and (moved.T, moved.E) == (12,
                                                                     tab.E)
    parts = list(tab)
    assert len(parts) == 5 and parts[0] is tab.avg_comm
    with pytest.raises(TypeError, match="avg_comm"):
        dp.RankTable(tab.avg_comm.float(), *parts[1:])
    with pytest.raises(ValueError, match="succ_ptr"):
        dp.RankTable(parts[0], parts[1][:-1], *parts[2:])
    with pytest.raises(ValueError, match="contiguous"):
        dp.RankTable(parts[0], parts[1], parts[2], parts[3],
                     torch.stack([parts[4], parts[4]], 1)[:, 0])
    with pytest.raises(ValueError, match="end at E"):
        dp.RankTable(parts[0], parts[1], parts[2][:-1], *parts[3:])
    with pytest.raises(ValueError, match="level_ptr of at least one"):
        dp.RankTable(*parts[:3], parts[3][:0], parts[4])
    with pytest.raises(AttributeError, match="checked once"):
        tab.avg_comm = tab.avg_comm.float()


def test_upward_rank_wrapper_checks_w_against_its_table():
    rng = np.random.default_rng(1)
    tab = _table(rng, 10)
    W = torch.from_numpy(rng.uniform(1.0, 9.0, (10, 3)))
    rank, bad = ref.upward_rank_ref([W], [tab])
    assert rank.shape == (1, 10) and bad.tolist() == [0]
    with pytest.raises(ValueError, match="CUDA"):
        dp.upward_rank([W], [tab])
    with pytest.raises(ValueError, match="one table per lane"):
        dp.upward_rank([W], [])
