"""Process-group start-up of the port (``parallel/multihost.py``,
``parallel/launch.py``, ``run_training --multihost``) on the CPU, after
``tests/test_multihost.py``.

Two real OS processes join one gloo group through ``multihost.initialize``
from torchrun's environment and all-reduce across the process boundary; two
``run_training --multihost`` processes train one step on a 2-rank mesh;
``initialize`` raises with no world; ``launch.spawn`` kills a rank left
waiting in a collective when its peer dies. Every child has a deadline and
is killed when it passes.
"""

import os
import subprocess
import sys
import time

import pytest
import torch

from sparse_pooling_tpu_torch.parallel import launch, multihost

import torch_parallel_workers as workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 180

_WORKER = r"""
import torch
import torch.distributed as dist

from sparse_pooling_tpu_torch.parallel import multihost

multihost.initialize()
info = multihost.process_info()
print(info, flush=True)
rank, world = dist.get_rank(), dist.get_world_size()
t = torch.arange(4, dtype=torch.float32) + 10 * rank
dist.all_reduce(t)
want = sum(torch.arange(4, dtype=torch.float32) + 10 * r for r in range(world))
assert torch.equal(t, want), (t, want)
assert multihost.check_collective() == world
print(f"ALL_REDUCE_OK process {rank}", flush=True)
multihost.shutdown()
"""


def run_ranks(argv, world: int, extra_env=None):
    """``argv`` as ``world`` OS processes with torchrun's environment; kills
    them all at the deadline. Returns their outputs; asserts rc 0."""

    port = launch.free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                   RANK=str(rank), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), **(extra_env or {}))
        procs.append(subprocess.Popen(argv, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True, cwd=REPO))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out}"
    return outs


def test_two_processes_join_from_the_environment():
    outs = run_ranks([sys.executable, "-c", _WORKER], 2)
    for rank, out in enumerate(outs):
        assert f"ALL_REDUCE_OK process {rank}" in out, out
        assert f"process {rank}/2 (gloo) on cpu" in out, out


def test_run_training_multihost_two_processes(tmp_path):
    from sparse_pooling_tpu_torch.data import synthetic
    from sparse_pooling_tpu_torch.parallel import dryrun
    from sparse_pooling_tpu_torch.runtime import checkpoint as ckpt_mod
    from sparse_pooling_tpu_torch.runtime.summary import read_scalars

    root = str(tmp_path / "kitti")
    synthetic.write_kitti_tree(root, num_frames=3, n_ground=512, n_obj=64, val_frames=(2,))
    cfg = dryrun.dryrun_config(root, str(tmp_path / "exp"), 2, 1)
    path = tmp_path / "pipeline.json"
    path.write_text(cfg.to_json())
    outs = run_ranks([sys.executable, "-m", "sparse_pooling_tpu_torch.experiments.run_training", "--multihost",
                      "--device", "cpu", "--pipeline_config", str(path), "--max_steps", "1"], 2)
    for rank, out in enumerate(outs):
        assert f"process {rank}/2 (gloo) on cpu" in out and "all_reduce of ones = 2" in out, out
    assert "mesh {'data': 2, 'model': 1}" in outs[0] and "finished at step 1" in outs[0], outs[0]
    workdir = tmp_path / "exp" / cfg.checkpoint_name
    assert ckpt_mod.all_steps(str(workdir / "checkpoints")) == [1]
    recs = read_scalars(str(workdir / "summaries"))
    assert [r["step"] for r in recs] == [1] and all(torch.isfinite(torch.tensor(r["total"])) for r in recs)


def test_initialize_raises_without_a_world(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="no world given.*MASTER_ADDR"):
        multihost.initialize()
    with pytest.raises(RuntimeError, match=r"Missing: rank \(RANK\)"):
        multihost.initialize("127.0.0.1:1", num_processes=2)


def test_backend_follows_the_device():
    assert multihost.default_backend("cpu") == "gloo"
    assert multihost.default_backend("cuda") == "nccl"
    assert multihost.default_backend("cuda:1") == "nccl"
    assert multihost.default_backend() == ("nccl" if torch.cuda.is_available() else "gloo")
    assert multihost.process_info().startswith("process 0/1 (no process group)")


def test_spawn_kills_a_rank_left_waiting_when_its_peer_dies():
    # rank 1 fails; rank 0 is killed, or leaves its barrier with an error
    # when its peer's connection closes, whichever comes first
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank [01] exited with code"):
        launch.spawn(workers.failing_rank, 2, timeout_s=60.0, threads=1)
    assert time.monotonic() - t0 < 45.0  # not the deadline: the parent saw the failure


def test_spawn_returns_every_ranks_result():
    assert launch.spawn(workers.failing_rank, 1, timeout_s=60.0, threads=1) == [0]


def test_the_import_guard_covers_parallel():
    """``tests/test_torch_port.py``'s guard (no JAX, no JAX package) reads
    every module of ``parallel/``; the ranks' functions import no JAX either."""

    from pathlib import Path

    from test_torch_port import FORBIDDEN, _imported_roots, _port_files

    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for module in ("__init__", "mesh", "multihost", "tensor_parallel", "launch", "dryrun"):
        assert f"sparse_pooling_tpu_torch/parallel/{module}.py" in names, module
    assert "sparse_pooling_tpu_torch/models/draws.py" in names
    assert not _imported_roots(Path(workers.__file__)) & set(FORBIDDEN)
