"""The port's data-parallel layer (``core/mesh.py``) against the JAX
package's ``core/mesh.py``, and its collectives on two gloo ranks.

Pure functions are held to the JAX ones exactly: ``auto_data_axis`` on a
grid of device counts and batch sizes, ``align_local_rows`` for every
(world, accum, rank), and ``iterate_batches``' per-rank shards for world
2 and 4 over epochs, ``drop_last`` and ``pad_to_full`` on a length that
leaves a partial tail.  The config surface parses the JAX CLI's
data- and tensor-parallel flags, and the data axis is the world over
``mesh_model``.

``init_distributed`` starts a group from the launcher's environment,
adopts it and destroys only its own.  The collectives on two ranks ride in
``tests/test_torch_dp_step.py``'s spawn (``collectives`` below runs in
each rank there): ``cross_host_sum`` exact past 2^24,
``cross_host_gather`` of payloads past 16 MB (as
``tests/test_multiprocess.py`` holds the JAX one), the gradient mean per
dtype, the broadcast and the agreement check, the differentiable batch
sum, and a ``GuideCache`` with a device table on each rank: each table
holds exactly the images of its rank's rows, and its gathers are the bf16
rounding of the host path, as ``tests/test_torch_ingest.py`` holds for one
process.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from mtvaf_tpu_torch.core import mesh
from mtvaf_tpu_torch.core.config import Config, config_from_args
from mtvaf_tpu_torch.data import datasets
from test_torch_gcn import one_torch_thread  # noqa: F401

IDS = [f"{810000 + i}.jpg" for i in range(4)]
BIG = [(1 << 24) + 3, (1 << 24) + 10]
DP_FIELDS = {"n_gpu": 1, "gpus": 1, "nodes": 1, "local_rank": -1,
             "mesh_data": 0, "mesh_model": 1}


def test_auto_data_axis_matches_jax():
    from mtvaf_tpu.core import mesh as jmesh
    for n in range(1, 10):
        for sizes in ((32, 16), (8,), (6, 4), (7,), (12, 18, 24), (1,),
                      (0,), (30, 45)):
            assert mesh.auto_data_axis(n, *sizes) \
                == jmesh.auto_data_axis(n, *sizes), (n, sizes)


def test_align_local_rows_matches_jax():
    from mtvaf_tpu.core import mesh as jmesh
    rows = np.arange(16 * 3).reshape(16, 3)
    for world in (1, 2, 4):
        for accum in (1, 2, 4):
            for p in range(world):
                np.testing.assert_array_equal(
                    mesh.align_local_rows(rows, 16 // world, accum, p),
                    jmesh.align_local_rows(rows, 16 // world, accum, p))
    # a rank's own rows pass through
    np.testing.assert_array_equal(mesh.align_local_rows(rows[:8], 8, 2, 1),
                                  rows[:8])


@pytest.mark.parametrize("world", [2, 4])
def test_iterate_batches_shards_as_jax(world):
    from mtvaf_tpu.data import datasets as jdatasets
    n, bsz = 23, 8                      # a tail of 7 rows
    arrays = {"x": np.arange(n * 2, dtype=np.int32).reshape(n, 2),
              "example_index": np.arange(n, dtype=np.int32)}
    for epoch in (1, 2):
        for drop_last in (False, True):
            for pad in (True, False):
                seen = []
                for rank in range(world):
                    kw = dict(shuffle=True, seed=5, epoch=epoch,
                              drop_last=drop_last, pad_to_full=pad,
                              process_index=rank, process_count=world)
                    got = list(datasets.iterate_batches(arrays, bsz, **kw))
                    want = list(jdatasets.iterate_batches(arrays, bsz, **kw))
                    assert len(got) == len(want)
                    for g, w in zip(got, want):
                        assert g.keys() == w.keys()
                        for k in w:
                            np.testing.assert_array_equal(g[k], w[k])
                        seen += list(g["example_index"][g["batch_valid"]
                                                        == 1])
                # the ranks' valid rows are the epoch's rows, each once
                expect = n - (n % bsz if drop_last else 0)
                assert sorted(seen) == sorted(set(seen)) and \
                    len(seen) == expect


def test_config_surface_and_what_still_raises():
    from mtvaf_tpu.core.config import Config as JaxConfig
    jax_defaults = JaxConfig()
    for name, default in DP_FIELDS.items():
        assert getattr(Config(), name) == default \
            == getattr(jax_defaults, name), name
    cfg = config_from_args(["--mesh_data", "2", "--nodes", "2", "--gpus",
                            "2", "--local_rank", "1", "--n_gpu", "2"])
    assert (cfg.mesh_data, cfg.nodes, cfg.gpus, cfg.local_rank,
            cfg.n_gpu) == (2, 2, 2, 1, 2)
    # nothing is refused any more: tensor parallelism is ported, and the
    # data axis is the world over mesh_model
    import mtvaf_tpu_torch.core.config as config_module
    assert not hasattr(config_module, "check_ported")
    cfg = config_from_args(["--mesh_data", "2", "--mesh_model", "2"])
    assert (cfg.mesh_data, cfg.mesh_model) == (2, 2)
    assert mesh.data_axis(Config(train_batch_size=8, eval_batch_size=4,
                                 mesh_model=2, mesh_data=2), 4) == 2
    with pytest.raises(ValueError, match="mesh_model=3 does not divide"):
        mesh.data_axis(Config(mesh_model=3), 4)
    with pytest.raises(ValueError, match=r"data axis 2 must divide .* "
                       r"eval_batch_size \(3\)"):
        mesh.data_axis(Config(train_batch_size=8, eval_batch_size=3,
                              mesh_model=2), 4)
    assert mesh.data_axis(Config(train_batch_size=8, eval_batch_size=4),
                          4) == 4
    with pytest.raises(ValueError, match=r"micro-batch \(3\) and "
                       r"eval_batch_size \(4\)"):
        mesh.data_axis(Config(train_batch_size=6, eval_batch_size=4,
                              gradient_accumulation_steps=2), 2)
    with pytest.raises(ValueError, match="mesh_data=2 but 4 processes"):
        mesh.data_axis(Config(mesh_data=2, train_batch_size=8,
                              eval_batch_size=8), 4)
    # one process: no group, every collective is the identity
    assert mesh.world_size() == 1 and mesh.is_primary()
    assert (mesh.data_size(), mesh.model_size(), mesh.data_rank(),
            mesh.model_rank()) == (1, 1, 0, 0)
    x = torch.ones(3, requires_grad=True)
    for move in (mesh.copy_to_tp, mesh.reduce_from_tp, mesh.gather_from_tp,
                 mesh.scatter_to_tp):
        assert move(x) is x
    np.testing.assert_array_equal(mesh.cross_host_sum([1, 2]), [1, 2])
    assert mesh.cross_host_gather("x") == ["x"]
    t = [torch.ones(2)]
    assert mesh.all_reduce_mean(t)[0] is t[0]


def test_init_distributed_from_the_launcher_environment(monkeypatch):
    """With the launcher's variables the CLI's group starts (gloo on the
    CPU), is adopted by a second call, and is destroyed only by its
    owner; with ``nodes > 1`` and no such variables it raises."""
    import torch.distributed as dist
    from _torch_dp import free_port

    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.init_distributed(Config(), "cpu") == (0, 1,
                                                      torch.device("cpu"))
    with pytest.raises(RuntimeError, match="lacks .*MASTER_ADDR"):
        mesh.init_distributed(Config(nodes=2), "cpu")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    try:
        assert mesh.init_distributed(Config(), "cpu") == (
            0, 1, torch.device("cpu"))
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert mesh.init_distributed(Config(), "cpu")[:2] == (0, 1)
    finally:
        mesh.shutdown_distributed()
    assert not dist.is_initialized()


# --- two ranks (run in tests/test_torch_dp_step.py's spawn) ---------------

def collectives(rank, world, workdir):
    """Rank ``rank``'s side of the spawned checks."""
    from mtvaf_tpu_torch.data.images import ImageStore
    from mtvaf_tpu_torch.train.ingest import GuideCache

    out = {}
    out["sum_int"] = mesh.cross_host_sum(
        np.asarray([(1 << 24) + 1, rank], np.int64))
    out["sum_float"] = mesh.cross_host_sum(np.asarray([0.25 * (rank + 1)]))
    payload = np.random.RandomState(rank).randint(
        0, 256, BIG[rank]).astype(np.uint8).tobytes()
    parts = mesh.cross_host_gather(payload)
    out["gather"] = [(len(p), hashlib.sha1(p).hexdigest()) for p in parts]

    means = mesh.all_reduce_mean([
        torch.full((3,), float(rank + 1)),
        torch.full((2, 2), rank + 1.5, dtype=torch.bfloat16),
        torch.full((1,), 2.0 * rank, dtype=torch.float64)])
    out["means"] = [(m.dtype, m.tolist()) for m in means]

    tree = {"a": torch.full((4,), float(rank)), "b": [torch.zeros(2)]}
    out["disagree"] = mesh.disagreeing_leaf(tree)
    mesh.broadcast_([tree["a"], tree["b"][0]])
    out["after_broadcast"] = (mesh.disagreeing_leaf(tree),
                              tree["a"].tolist())

    x = torch.tensor(float(rank + 1), requires_grad=True)
    with mesh.data_parallel_step(world):
        y = mesh.batch_sum(x * x)
        rows = mesh.batch_rows(3)
    (g,) = torch.autograd.grad(y, [x])
    out["batch_sum"] = (y.item(), g.item(), rows)

    # the guide table of this rank's rows
    resnet = torch.load(os.path.join(workdir, "resnet.pt"),
                        weights_only=True)
    store = ImageStore(os.path.join(workdir, "imgs"), None)
    host = GuideCache(resnet, 18, device="cpu")
    table = GuideCache(resnet, 18, device_items=16, device="cpu")
    arrays = {"example_index": np.arange(len(IDS), dtype=np.int32)}
    own, exact = set(), True
    for b in datasets.iterate_batches(arrays, 2, shuffle=True, seed=3,
                                      epoch=1, process_index=rank,
                                      process_count=world):
        ids = [IDS[i] for i in b["example_index"]]
        own.update(ids)
        dm, da = table.batch(ids, store)
        hm, ha = host.batch(ids, store)
        exact &= isinstance(dm, torch.Tensor) and torch.equal(
            dm, torch.from_numpy(hm).to(torch.bfloat16)) and torch.equal(
            da, torch.from_numpy(ha).to(torch.bfloat16))
    out["table"] = {"keys": sorted(k[1] for k in table._dev_rows),
                    "own": sorted(own), "bf16_of_host": exact,
                    "computed": table.computed}
    return out
