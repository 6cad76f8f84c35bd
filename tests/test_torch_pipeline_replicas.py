"""The GPipe step one stage a rank under data parallelism (`grove_tpu_torch.
parallel.pipeline`'s `RankPipe` in a world of N x D ranks: D replicas of
an N-stage pipeline, `train.step.make_pipelined_train_step`, the driver's
`--multihost --pipeline_stages N`) on the CPU, over 4 spawned gloo ranks
(`parallel.launch`, each launch under its own time limit), as 2 stages x 2
replicas (rank r stage r % 2 of replica r // 2):

* `GroveConfig.tiny()` in fp32 (2 layers, the decoder trainable, each
  layer under `torch.utils.checkpoint`), 2 rows a rank, 2 microbatches a
  replica: the loss equals the JAX `make_pipelined_train_step` on the
  8-row global batch (a 2-stage pipe mesh of the CPU's host devices, its
  microbatches splitting the global batch) within 2e-3 relative; each
  loss term equals the port's sequential step on that batch within 1e-5
  relative, every trainable gradient within 1e-4 (zeros where the
  sequential step has none), the clipping norm within 1e-5 relative.
  After 2 steps the replicas' copies of each stage's layers and moments,
  and every rank's copy of the replicated rest, have equal bit sums
  (`parallel.workers.bit_sums`, per tensor).
* The driver: `--multihost --pipeline_stages 2` over 4 ranks against
  `--multihost` data parallelism over 4 ranks on the same shards. The
  synthetic set holds max(4, 2 x `--batch_size`) clips, so 4 ranks take
  one row each, and a replica's 2 rows run as one microbatch. Its
  checkpoint (rank 0, world 1's names and shapes) lies within 2e-5 of
  data parallelism's after 2 steps, with the same validation losses;
  `--auto_resume` from step 1 restores every rank's own state bit-equal
  to the checkpoint, and the next step stays within 2e-5 of data
  parallelism resumed the same way.
* A world of 3 with `--pipeline_stages 2` is refused.
"""

import json
import re
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grove_tpu.checkpoint.torch_convert import to_torch_state_dict  # noqa
from grove_tpu.config import GroveConfig  # noqa: E402
from grove_tpu.models.grove import init_grove_params  # noqa: E402
from grove_tpu.parallel import pipeline as jpipe  # noqa: E402
from grove_tpu.train import step as jstep  # noqa: E402
from grove_tpu_torch.checkpoint.convert import (  # noqa: E402
    load_reference_state_dict)
from grove_tpu_torch.models.grove import GroveModel  # noqa: E402
from grove_tpu_torch.parallel.dryrun import dummy_batch  # noqa: E402
from grove_tpu_torch.parallel.launch import launch  # noqa: E402
from grove_tpu_torch.parallel.workers import grove_config  # noqa: E402
from grove_tpu_torch.train import step as tstep  # noqa: E402
from test_torch_parity import _perturb_zeros, port_config  # noqa: E402
from test_torch_pipeline_ranks import (  # noqa: E402
    _assert_close, _ckpt, _flat, _val_losses)

TOL = 2e-3               # port vs JAX (the parity suite's)
TERM_REL = 1e-5          # loss terms, ranks vs the sequential step
GRAD_TOL = 1e-4          # gradients, ranks vs the sequential step, fp32
LAUNCH_S = 240           # each launch's own time limit
STAGES = 2
REPLICAS = 2
RANKS = STAGES * REPLICAS
LOCAL = 2                # rows a rank
WORKER = ["-m", "grove_tpu_torch.parallel.workers"]


@pytest.fixture(scope="module")
def replicated(tmp_path_factory):
    """Two steps of the 2 x 2 pipelined step, the JAX step's metrics, and
    the port's sequential step (its loss terms, gradients and clipping
    norm) on the same weights and global batch."""
    cfg = GroveConfig.tiny()
    jmodel, variables = init_grove_params(cfg, jax.random.PRNGKey(0),
                                          dtype=jnp.float32, batch=4)
    params = _perturb_zeros(variables["params"], np.random.default_rng(0))
    tmp = tmp_path_factory.mktemp("replicas")
    batch = dummy_batch(cfg, RANKS * LOCAL, np.random.default_rng(4))
    jcfg = jstep.OptimizerConfig(total_steps=10, warmup_steps=2,
                                 full_llm=True)
    opt = jstep.make_optimizer(params, jcfg)
    trainable, frozen = jstep.partition_params(
        params, jstep.trainable_mask(params, jcfg))
    _, _, jm = jax.jit(jstep.make_pipelined_train_step(
        jmodel, opt, jpipe.make_pipe_mesh(STAGES), 2))(
            trainable, frozen, opt.init(trainable),
            {k: jnp.asarray(v) for k, v in batch.items()})

    assert port_config(cfg) == grove_config()
    base = GroveModel(port_config(cfg), device="cpu", dtype=torch.float32)
    load_reference_state_dict(base, to_torch_state_dict(params, cfg))
    torch.save(base.state_dict(), tmp / "weights.pt")
    torch.save(batch, tmp / "batch.pt")
    # lr(0) = 0: the first step moves no weight, so the second step's
    # gradients, whose clipping norm the run reports, are the first's
    ocfg = {"total_steps": 10, "warmup_steps": 2, "full_llm": True}
    launch([*WORKER, "pipeline_step", json.dumps(dict(
        out=str(tmp / "run.pt"), batch=str(tmp / "batch.pt"),
        microbatches=2, weights=str(tmp / "weights.pt"), optimizer=ocfg,
        remat=True, steps=2, replicas=REPLICAS, device="cpu"))], RANKS,
        timeout=LAUNCH_S)
    got = torch.load(tmp / "run.pt", weights_only=False)

    model = GroveModel(port_config(cfg), remat=True, device="cpu",
                       dtype=torch.float32)
    model.load_state_dict(base.state_dict())
    tp = tstep.partition_params(
        model, tstep.trainable_mask(model, tstep.OptimizerConfig(**ocfg)))
    opt_t = tstep.make_optimizer(tp, tstep.OptimizerConfig(**ocfg))
    out = tstep.make_train_step(model, opt_t)(
        tstep.batch_to_device(batch, "cpu"))
    seq = ({k: float(v) for k, v in out.items()},
           {n: p.grad for n, p in tp.items() if p.grad is not None},
           float(opt_t.global_norm()))
    return got, jm, seq


def test_replicas_match_jax_pipelined_step(replicated):
    got, jm, _ = replicated
    loss = got["metrics"][0]["loss"]
    assert abs(loss - float(jm["loss"])) <= TOL * abs(loss)


def test_replicas_match_sequential_step(replicated):
    got, _, (terms, grads, norm) = replicated
    for k, v in terms.items():
        assert abs(got["metrics"][0][k] - v) <= TERM_REL * max(1.0, abs(v)), k
    assert set(got["grads"]) >= set(grads)
    for n in set(got["grads"]) - set(grads):
        assert not got["grads"][n].any(), n
    assert len([n for n in grads if n.startswith("model.layers.")]) == 18
    for n, g in grads.items():
        np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=n)
    assert abs(got["norm"] - norm) <= TERM_REL * norm


def test_rank_layout(replicated):
    for rank, r in enumerate(replicated[0]["ranks"]):
        stage = rank % STAGES
        assert (r["replica"], r["stage"]) == (rank // STAGES, stage)
        assert r["held"] == [stage] and r["meta"] == [1 - stage]
        assert r["transport"] == "gloo"


@pytest.mark.parametrize("kind", ["params", "mu", "nu"])
def test_replicas_stay_bit_equal(replicated, kind):
    """After 2 steps: each stage's two copies equal in full (its layers
    and the rest), and the rest equal on all 4 ranks."""
    ranks = replicated[0]["ranks"]
    sums = [r["after"][kind] for r in ranks]
    for stage in range(STAGES):
        assert sums[stage] == sums[stage + STAGES]
        assert any(n.startswith(f"model.layers.{stage}.")
                   for n in sums[stage])
    rest = {n: v for n, v in sums[0].items()
            if not n.startswith("model.layers.")}
    assert rest
    for s in sums[1:]:
        assert {n: s[n] for n in rest} == rest


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

COMMON = ["--device", "cpu", "--synthetic", "--model_size", "tiny",
          "--epochs", "2", "--steps_per_epoch", "1", "--num_workers", "1",
          "--warmup_steps", "0", "--lr", "1e-3", "--seed", "42",
          "--val_mode", "loss", "--pipeline_microbatches", "1",
          "--batch_size", "1"]
DATA_PARALLEL = ["-m", "grove_tpu_torch.train.driver", "--multihost",
                 *COMMON]
PIPELINED = [*DATA_PARALLEL, "--pipeline_stages", str(STAGES)]


def _together(*argvs):
    """Each of `argvs` launched on RANKS ranks, the launches at once; each
    one's outputs."""
    with ThreadPoolExecutor(len(argvs)) as pool:
        return list(pool.map(
            lambda argv: launch(argv, RANKS, timeout=LAUNCH_S), argvs))


def test_replicated_driver_matches_data_parallelism_and_resumes(tmp_path):
    dp, pp = tmp_path / "dp", tmp_path / "pp"
    want, outs = _together([*DATA_PARALLEL, "--log_base_dir", str(dp)],
                           [*PIPELINED, "--log_base_dir", str(pp)])
    assert all("training done: 2 steps" in o for o in outs)
    assert "2 stages x 1 layers, one a rank, 2 stages x 2 replicas" in outs[0]
    for rank, o in enumerate(outs):
        assert (f"replica {rank // STAGES}, stage {rank % STAGES}, layers "
                f"{rank % STAGES}-{rank % STAGES}") in o
    assert "the global batch of 4 rows" in outs[0]
    want_val = _val_losses(want[0])
    assert len(want_val) == 2
    np.testing.assert_allclose(_val_losses(outs[0]), want_val, atol=2e-4)
    _assert_close(_ckpt(pp), _ckpt(dp))

    for root in (dp, pp):
        shutil.copytree(root, f"{root}_resumed")
        shutil.rmtree(tmp_path / f"{root.name}_resumed" / "grove_tpu" /
                      "ckpt_model" / "2")
    state = tmp_path / "restored.pt"
    _, outs = _together(
        [*DATA_PARALLEL, "--auto_resume", "--log_base_dir",
         str(tmp_path / "dp_resumed")],
        [*WORKER, "driver", json.dumps(dict(
            argv=PIPELINED[2:] + ["--auto_resume", "--log_base_dir",
                                  str(tmp_path / "pp_resumed")],
            state_out=str(state), device="cpu"))])
    assert all("resumed from step 1 (epoch 1)" in o for o in outs)
    saved = _flat(_ckpt(pp, 1))
    saved = {k: v for k, v in saved.items() if not k.startswith("extra")}
    restored = _flat(torch.load(state, weights_only=True))
    assert set(restored) == set(saved)
    for rank in range(RANKS):
        own = _flat(torch.load(f"{state}.rank{rank}", weights_only=True))
        layer = re.compile(rf"model\.layers\.(?!{rank % STAGES}\.)")
        assert {k for k in saved if not layer.search(k)} == set(own), rank
        for k, v in own.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, saved[k]), (rank, k)
            else:
                assert v == saved[k], (rank, k)
    _assert_close(_ckpt(tmp_path / "pp_resumed"),
                  _ckpt(tmp_path / "dp_resumed"))


def test_world_not_a_multiple_of_the_stages_is_refused(tmp_path):
    with pytest.raises(RuntimeError, match=r"--pipeline_stages 2 across "
                       r"processes runs one stage a rank: the world holds "
                       r"3 processes, not 2 or a multiple of 2"):
        launch([*PIPELINED, "--log_base_dir", str(tmp_path)], 3,
               timeout=LAUNCH_S)
