"""The port's multi-process input and checkpoint helpers
(``instag_torch/parallel/multihost.py``) against the JAX package's:
``frame_shard`` and ``sample_local_rows`` equal for every (n, P) of
``tests/test_parallel.py``; ``MultihostFrameStore`` rows equal to the
records of the rank's shard; ``save_bundle_multihost`` on 2 gloo ranks
(one spawn, under its own time limit) writing the bytes a single-process
``save_bundle`` writes of the whole tree; ``init_multihost`` without
coordinator information touching nothing; the launcher refusing to start
ranks on a card that is not there.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from instag_torch.data.dataset import load_frames
from instag_torch.data.synthetic import generate_scene
from instag_torch.io.checkpoints import save_bundle
from instag_torch.parallel import multihost as MH
from instag_torch.parallel.launch import spawn
from instag_torch.train.common import build_frame_batch
from tests.torch_cpu import one_torch_thread  # noqa: F401

CASES = [(250, 4), (7, 3), (8, 8), (5, 8), (1000, 16)]


@pytest.mark.parametrize("n,P", CASES)
def test_frame_shard_and_local_rows_match_jax(n, P):
    from instag_tpu.parallel import frame_shard, sample_local_rows
    covered = []
    for p in range(P):
        s = MH.frame_shard(n, p, P)
        assert s == frame_shard(n, p, P)
        covered.extend(range(s.start, s.stop))
        if s.stop > s.start:
            ours = MH.sample_local_rows(np.random.default_rng(p), s, 64)
            ref = sample_local_rows(np.random.default_rng(p), s, 64)
            np.testing.assert_array_equal(ours, ref)
    assert covered == list(range(n))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mh_scene") / "scene")
    generate_scene(path, n_frames=7, size=16, n_val=1, device="cpu")
    return load_frames(path, device="cpu")


@pytest.mark.parametrize("pi,pc", [(0, 1), (1, 3), (2, 3)])
def test_store_rows_equal_the_records(records, pi, pc):
    store = MH.MultihostFrameStore(records, process_index=pi,
                                   process_count=pc, device="cpu")
    assert store.shard == MH.frame_shard(len(records), pi, pc)
    mine = records[store.shard]
    idx = [len(mine) - 1, 0, len(mine) - 1]
    blk = store.gather_global(idx)
    ref = build_frame_batch([mine[i] for i in idx], device="cpu")
    for k, v in vars(ref).items():
        if v is None:
            assert getattr(blk, k) is None, k
        else:
            assert torch.equal(getattr(blk, k), v), k
    local = MH.make_global_batch(
        {k: None if v is None else v.numpy() for k, v in vars(ref).items()},
        device="cpu")
    assert torch.equal(local.image, ref.image)


def _tree(rank, world, auds):
    shard = MH.frame_shard(len(auds), rank, world)
    return {"auds": MH.Shard(auds[shard]),
            "alive": MH.Shard(auds[shard, 0, 0, 0] > 0),
            "scale": np.float32(2.5), "it": 7, "name": "mh",
            "nested": {"ids": MH.Shard(np.arange(len(auds))[shard])}}


def _rank_save(rank, group, dev, auds, path):
    torch.set_num_threads(1)
    again = MH.init_multihost(device="cpu")         # idempotent: joined
    MH.save_bundle_multihost(path, _tree(rank, dist.get_world_size(), auds))
    return dict(again=again, exists=os.path.exists(path),
                group_is_world=MH.global_mesh() is group)


def test_save_bundle_multihost_on_two_ranks(tmp_path):
    auds = np.random.default_rng(3).normal(
        size=(7, 2, 3, 4)).astype(np.float32)
    path = str(tmp_path / "mh.pkl")
    outs = spawn(_rank_save, 2, (auds, path), device="cpu", timeout=120.0)
    assert all(o["again"] and o["exists"] and o["group_is_world"]
               for o in outs)
    whole = {k: (v.rows if isinstance(v, MH.Shard) else v)
             for k, v in _tree(0, 1, auds).items()}
    whole["nested"] = {"ids": np.arange(7)}
    single = str(tmp_path / "single.pkl")
    save_bundle(single, whole)
    with open(path, "rb") as a, open(single, "rb") as b:
        assert a.read() == b.read()


def test_init_multihost_without_coordinator(monkeypatch, tmp_path):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert MH.init_multihost() is False
    assert not dist.is_initialized()
    assert MH.global_mesh() is None
    # one process: the bundle of the shards is the single-process bundle
    auds = np.arange(12, dtype=np.float32).reshape(3, 4)
    MH.save_bundle_multihost(str(tmp_path / "a.pkl"),
                             {"a": MH.Shard(auds), "it": 1})
    save_bundle(str(tmp_path / "b.pkl"), {"a": auds, "it": 1})
    assert (tmp_path / "a.pkl").read_bytes() == (tmp_path /
                                                 "b.pkl").read_bytes()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal "
                    "without a card")
def test_spawn_defaults_to_the_card():
    """The launcher's ranks run on the card unless the caller asks for the
    CPU: without a card it refuses before it starts a process."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(_rank_save, 2, (None, None), timeout=10.0)
