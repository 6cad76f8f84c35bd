"""The port's multi-process programs, each run by spawned gloo processes
on the CPU: `parallel.dryrun.dryrun_multichip(2)` and `(4)` (the
counterpart of `__graft_entry__.dryrun_multichip`: TP x FSDP x sequence
parallelism, the 2-stage pipelined step and the DDP inference leg), the
multi-host demo with 2 processes (disjoint shards, one global loss on
every rank), TP greedy decode over 2 ranks (the same tokens as unsharded,
`tests/test_multichip.py:165`), and `parallel.launch`'s time limit and
failure handling. Each launch has its own time limit and kills its
processes on failure; the workers import no JAX."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grove_tpu_torch.infer.generate import greedy_decode  # noqa: E402
from grove_tpu_torch.models.grove import init_grove_params  # noqa: E402
from grove_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from grove_tpu_torch.parallel.launch import launch  # noqa: E402
from grove_tpu_torch.parallel.workers import grove_config  # noqa: E402
from grove_tpu_torch.tools import multihost_demo  # noqa: E402

LAUNCH_S = 240           # each launch's own time limit


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    line = dryrun_multichip(n, timeout=LAUNCH_S)
    model = 2 if n == 4 else 1
    assert f"mesh={{'data': {n // model}, 'model': {model}}}" in line
    assert "pp(2-stage full step)=" in line and line.endswith("OK")
    loss = float(line.split(" loss=")[1].split()[0])
    assert np.isfinite(loss)


def test_multihost_demo_two_processes(tmp_path):
    result = multihost_demo.main(["--num_processes", "2", "--steps", "2",
                                  "--device", "cpu", "--workdir",
                                  str(tmp_path), "--timeout",
                                  str(LAUNCH_S)])
    assert len(result["shards"]) == 2
    assert not set(result["shards"][0]) & set(result["shards"][1])
    assert sorted(result["losses"]) == [0, 1]


def test_tp_greedy_decode_matches_unsharded(tmp_path):
    """Greedy decode with the TP rules over 2 ranks (fp32 cache) == the
    unsharded model's tokens."""
    cfg = grove_config()
    rng = np.random.default_rng(0)
    nv = cfg.num_video_tokens
    ids = rng.integers(3, 100, size=(2, nv + 6)).astype(np.int64)
    ids[:, 0] = cfg.tokens.bos
    ids[:, 2:2 + nv] = 0
    data = {"ids": ids, "starts": np.full((2,), 2, np.int64),
            "feats": rng.normal(size=(2, nv, cfg.llama.hidden_size)).astype(
                np.float32)}
    model = init_grove_params(cfg, device="cpu", dtype=torch.float32, seed=1)
    weights = tmp_path / "tiny.pt"
    torch.save(model.state_dict(), weights)
    with torch.inference_mode():
        want, _ = greedy_decode(
            model, torch.as_tensor(ids),
            torch.as_tensor(data["feats"]), data["starts"],
            max_new_tokens=5, eos_id=cfg.tokens.eos,
            cache_dtype=torch.float32)
    inputs, out = tmp_path / "dec_in.pt", tmp_path / "dec_out.pt"
    torch.save(data, inputs)
    launch(["-m", "grove_tpu_torch.parallel.workers", "greedy", json.dumps(
        dict(weights=str(weights), inputs=str(inputs), out=str(out),
             tp=2, device="cpu"))], 2, timeout=LAUNCH_S)
    assert torch.load(out, weights_only=False) == want.tolist()


def test_launch_fails_fast_and_kills(tmp_path):
    """A rank that exits non-zero fails the launch; a rank that hangs is
    killed at the time limit."""
    with pytest.raises(RuntimeError, match="failed"):
        launch(["-c", "import os, sys; sys.exit(int(os.environ['RANK']))"],
               2, timeout=60)
    with pytest.raises(TimeoutError):
        launch(["-c", "import time; time.sleep(600)"], 2, timeout=2)


def test_multihost_demo_needs_a_batch_a_shard():
    """Four processes over the default 4 clips would leave each shard
    without a full batch of 2: the parent refuses before it starts any."""
    with pytest.raises(ValueError, match="needs a full batch"):
        multihost_demo.main(["--num_processes", "4", "--device", "cpu"])
