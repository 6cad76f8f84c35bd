"""The training driver's parallel flags on synthetic data, on the CPU
(`grove_tpu_torch.train.driver`, `grove_tpu/train/driver.py:281-360`):

* `--multihost --mesh_model 2` over 2 spawned gloo ranks (tensor
  parallelism, one data rank): its checkpoint (rank 0 alone writes it,
  each sharded parameter and moment gathered whole) equals the world-1
  run's within 2e-5 after 2 steps (`_assert_close`: tensors whose gradient
  is zero up to rounding are held to that);
* `--multihost` over 2 ranks (data parallelism, a batch of 1 a rank):
  both ranks log the same global losses at every step, one checkpoint of
  whole tensors with the world-1 run's names and shapes is written;
* `--pipeline_stages 2 --pipeline_microbatches 2` (one process, both
  stages on the CPU): its checkpoint equals the world-1 run's within 2e-5;
  and JAX's asserts (`:346-352`) raise.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grove_tpu_torch.parallel.launch import launch  # noqa: E402
from grove_tpu_torch.train import driver  # noqa: E402

TOL = 2e-5               # parallel vs world-1 checkpoints after 2 steps
ZERO_GRAD = 1e-6         # a first moment zero up to rounding, of the largest
LAUNCH_S = 300
COMMON = ["--device", "cpu", "--synthetic", "--model_size", "tiny",
          "--epochs", "1", "--steps_per_epoch", "2", "--num_workers", "1",
          "--warmup_steps", "0", "--lr", "1e-3", "--seed", "42"]


def _ckpt(root):
    return torch.load(root / "grove_tpu" / "ckpt_model" / "2" / "state.pt",
                      weights_only=True)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _assert_close(got, want):
    """Every tensor within TOL, but for the few trainable tensors whose
    gradient is zero up to rounding (a first moment not zero but below
    ZERO_GRAD of the largest, as the attention's key biases: softmax
    ignores a shift of the keys): Adam turns such a gradient's rounding
    noise into steps of about lr, so those tensors and their moments are
    held only to a zero-up-to-rounding first moment in both runs."""
    mus = {n: float(m.abs().max())
           for n, m in want["opt_state"]["mu"].items()}
    top = max(mus.values())
    noise = {n for n, m in mus.items() if 0.0 < m <= ZERO_GRAD * top}
    assert len(noise) <= 8, sorted(noise)
    for n in noise:
        assert float(got["opt_state"]["mu"][n].abs().max()) <= ZERO_GRAD * top
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        if k.split("/")[-1] in noise:
            continue
        if isinstance(w, torch.Tensor):
            np.testing.assert_allclose(got[k].float().numpy(),
                                       w.float().numpy(), rtol=TOL, atol=TOL,
                                       err_msg=k)
        else:
            assert got[k] == w, k


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """The world-1 run at batch 2."""
    root = tmp_path_factory.mktemp("world1")
    driver.main(COMMON + ["--batch_size", "2", "--log_base_dir", str(root)])
    return _ckpt(root)


def test_tensor_parallel_driver_checkpoint_equals_world1(world1, tmp_path):
    outs = launch(["-m", "grove_tpu_torch.train.driver", "--multihost",
                   "--mesh_model", "2", *COMMON, "--batch_size", "2",
                   "--log_base_dir", str(tmp_path)], 2, timeout=LAUNCH_S)
    assert all("training done: 2 steps" in o for o in outs)
    _assert_close(_ckpt(tmp_path), world1)


def _losses(out):
    return re.findall(r"\tloss (\S+) ", out)


def test_data_parallel_driver_logs_one_global_loss(world1, tmp_path):
    outs = launch(["-m", "grove_tpu_torch.train.driver", "--multihost",
                   *COMMON, "--batch_size", "1", "--log_base_dir",
                   str(tmp_path)], 2, timeout=LAUNCH_S)
    losses = [_losses(o) for o in outs]
    assert len(losses[0]) == 2 and losses[0] == losses[1], losses
    got = _ckpt(tmp_path)
    steps = sorted(p.name for p in (tmp_path / "grove_tpu" /
                                    "ckpt_model").iterdir())
    assert steps == ["2"]
    flat, want = _flat(got), _flat(world1)
    assert set(flat) == set(want)
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            assert flat[k].shape == w.shape, k
            assert bool(torch.isfinite(flat[k].float()).all()), k


def test_pipelined_driver_checkpoint_equals_world1(world1, tmp_path):
    driver.main(COMMON + ["--batch_size", "2", "--pipeline_stages", "2",
                          "--pipeline_microbatches", "2", "--log_base_dir",
                          str(tmp_path)])
    _assert_close(_ckpt(tmp_path), world1)


@pytest.mark.parametrize("flags,match", [
    (["--pipeline_stages", "3"], "does not divide 2 layers"),
    (["--pipeline_stages", "2", "--batch_size", "3"], "microbatches")])
def test_pipeline_flags_are_checked(tmp_path, flags, match):
    with pytest.raises(ValueError, match=match):
        driver.main(COMMON + ["--pipeline_microbatches", "2",
                              "--log_base_dir", str(tmp_path), *flags])
