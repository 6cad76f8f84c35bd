"""The GPipe step one stage a rank (`grove_tpu_torch.parallel.pipeline`'s
`RankPipe`, `train.step.make_pipelined_train_step`, the driver's
`--multihost --pipeline_stages N`) on the CPU, over spawned gloo ranks
(`parallel.launch`, each launch under its own time limit):

* 2 ranks x 2 stages at `GroveConfig.tiny()` in fp32 (2 layers, the
  decoder trainable, each layer under `torch.utils.checkpoint`), a local
  batch of 2 rows each: the loss equals the JAX
  `make_pipelined_train_step` on the 4-row global batch (a 2-stage pipe
  mesh of the CPU's host devices) within 2e-3 relative; each loss term
  equals the port's sequential step (remat too) on that batch within
  1e-5 relative, every trainable gradient within 1e-4 (zeros where the
  sequential step has none), the clipping norm within 1e-5 relative;
  each rank holds its stage's layers and the other stage's on the meta
  device only. Validation's forward (`RankPipelineModel`) on each rank's
  rows equals the sequential `forward_boxes` and `forward_train` on
  them.
* The clipping norm one stage a rank (`AdamW.sum_norm_over_`), with fp32
  and with bf16 moments, on bf16 and fp32 gradients over 4 layers on 2
  ranks: bit-equal to one process's over every layer.
* The driver: `--multihost --pipeline_stages 2` over 2 ranks (2 rows a
  rank, 2 microbatches, `--val_mode loss`), each rank reading its shard
  of the data as a data-parallel rank does, against `--multihost` data
  parallelism on the same shards (the same global batch; its checkpoint
  holds world 1's names and shapes, `test_torch_distributed_driver.py`):
  its checkpoint (rank 0 writes every stage's layers and moments) within
  2e-5 after 2 steps and the same validation loss; `--auto_resume` from
  its first step's checkpoint restores every rank's layers and moments
  bit-equal to the uninterrupted run's state, and its next step stays
  within 2e-5 of data parallelism's resumed the same way.
* Refusals: a world of 2 with `--pipeline_stages 4`, and `--mesh_model 2`
  with `--pipeline_stages 2`.
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
from grove_tpu_torch.train import driver  # noqa: E402
from grove_tpu_torch.train import step as tstep  # noqa: E402
from test_torch_parity import _perturb_zeros, port_config  # noqa: E402

TOL = 2e-3               # port vs JAX (the parity suite's)
TERM_REL = 1e-5          # loss terms, ranks vs the sequential step
GRAD_TOL = 1e-4          # gradients, ranks vs the sequential step, fp32
CKPT_TOL = 2e-5          # driver checkpoints vs world 1 after 2 steps
ZERO_GRAD = 1e-6         # a first moment zero up to rounding, of the largest
LAUNCH_S = 240           # each launch's own time limit
RANKS = 2
LOCAL = 2                # rows a rank
WORKER = ["-m", "grove_tpu_torch.parallel.workers"]


@pytest.fixture(scope="module")
def tiny():
    cfg = GroveConfig.tiny()
    jmodel, variables = init_grove_params(cfg, jax.random.PRNGKey(0),
                                          dtype=jnp.float32, batch=4)
    params = _perturb_zeros(variables["params"], np.random.default_rng(0))
    return cfg, jmodel, params


@pytest.fixture(scope="module")
def ranked(tiny, tmp_path_factory):
    """The 2-rank pipelined step's results, the JAX step's metrics, and the
    port's sequential step (its loss terms, gradients and clipping norm,
    and the model) on the same weights and global batch."""
    cfg, jmodel, params = tiny
    tmp = tmp_path_factory.mktemp("ranks")
    batch = dummy_batch(cfg, RANKS * LOCAL, np.random.default_rng(3))
    jcfg = jstep.OptimizerConfig(total_steps=10, warmup_steps=2,
                                 full_llm=True)
    opt = jstep.make_optimizer(params, jcfg)
    trainable, frozen = jstep.partition_params(
        params, jstep.trainable_mask(params, jcfg))
    _, _, jm = jax.jit(jstep.make_pipelined_train_step(
        jmodel, opt, jpipe.make_pipe_mesh(RANKS), 2))(
            trainable, frozen, opt.init(trainable),
            {k: jnp.asarray(v) for k, v in batch.items()})

    assert port_config(cfg) == grove_config()
    base = GroveModel(port_config(cfg), device="cpu", dtype=torch.float32)
    load_reference_state_dict(base, to_torch_state_dict(params, cfg))
    torch.save(base.state_dict(), tmp / "weights.pt")
    torch.save(batch, tmp / "batch.pt")
    ocfg = {"total_steps": 10, "warmup_steps": 2, "full_llm": True}
    launch([*WORKER, "pipeline_step", json.dumps(dict(
        out=str(tmp / "run.pt"), batch=str(tmp / "batch.pt"),
        microbatches=2, weights=str(tmp / "weights.pt"), optimizer=ocfg,
        remat=True, val=True, device="cpu"))], RANKS, timeout=LAUNCH_S)
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
    return got, jm, seq, base, batch


def test_ranks_match_jax_pipelined_step(ranked):
    got, jm, _, _, _ = ranked
    loss = got["metrics"][0]["loss"]
    assert abs(loss - float(jm["loss"])) <= TOL * abs(loss)


def test_ranks_match_sequential_step(ranked):
    got, _, (terms, grads, norm), _, _ = ranked
    for k, v in terms.items():
        assert abs(got["metrics"][0][k] - v) <= TERM_REL * max(1.0, abs(v)), k
    # `sync_gradients` gives a trainable parameter without a gradient zeros
    assert set(got["grads"]) >= set(grads)
    for n in set(got["grads"]) - set(grads):
        assert not got["grads"][n].any(), n
    layers = [n for n in grads if n.startswith("model.layers.")]
    assert len(layers) == 18, layers
    for n, g in grads.items():
        np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=n)
    assert abs(got["norm"] - norm) <= TERM_REL * norm


def test_each_rank_holds_only_its_stage(ranked):
    got = ranked[0]
    for rank, r in enumerate(got["ranks"]):
        assert r["stage"] == rank and r["layers"] == [rank]
        assert r["held"] == [rank] and r["meta"] == [1 - rank]
        assert r["transport"] == "gloo"
        assert not any(n.startswith(f"model.layers.{1 - rank}.")
                       for n in r["fingerprint"])


def test_ranks_validation_forward_matches_sequential(ranked):
    got, _, _, base, batch = ranked
    whole = tstep.batch_to_device(batch, "cpu")
    with torch.inference_mode():
        boxes = base.forward_boxes(whole)
    for rank, r in enumerate(got["ranks"]):
        rows = slice(rank * LOCAL, (rank + 1) * LOCAL)
        for k, v in boxes.items():
            np.testing.assert_allclose(r["val"]["boxes"][k].numpy(),
                                       v[rows].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        with torch.inference_mode():
            terms = base.forward_train(tstep.batch_to_device(
                {k: v[rows] for k, v in batch.items()}, "cpu"))
        for k, v in terms.items():
            if k.endswith("loss"):
                assert abs(r["val"]["losses"][k] - float(v)) <= \
                    TERM_REL * max(1.0, abs(float(v))), k


# ---------------------------------------------------------------------------
# the clipping norm one stage a rank
# ---------------------------------------------------------------------------

NORM_SCRIPT = """
import re
import sys

import numpy as np
import torch
import torch.distributed as dist

from grove_tpu_torch.parallel.mesh import init_distributed
from grove_tpu_torch.parallel.pipeline import stage_layers
from grove_tpu_torch.train.step import OptimizerConfig, make_optimizer

LAYERS = 4


def norm_params(layers):
    # named as a GroveModel's: a tower and the embedding before the
    # decoder layers, the final norm and the head after; bf16 and fp32
    # gradients drawn from one seed; `layers` of LAYERS held
    rng = np.random.default_rng(5)
    names = (["model.vision_tower.proj.weight", "model.embed_tokens.weight"]
             + [f"model.layers.{i}.{leaf}" for i in range(LAYERS)
                for leaf in ("self_attn.q_proj.weight",
                             "input_layernorm.weight", "mlp.up_proj.weight")]
             + ["model.norm.weight", "lm_head.weight"])
    out = {}
    for name in names:
        dtype = torch.float32 if "norm" in name else torch.bfloat16
        shape = (37,) if "norm" in name else (61, 29)
        g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        m = re.match(r"model[.]layers[.]([0-9]+)[.]", name)
        if m is None or int(m.group(1)) in layers:
            p = torch.nn.Parameter(torch.zeros(shape, dtype=dtype))
            p.grad = (g * 0.3).to(dtype)
            out[name] = p
    return out


def norm(params, stage=None):
    opt = make_optimizer(params, OptimizerConfig(moment_dtype=moments))
    if stage is not None:
        opt.sum_norm_over_(stage, LAYERS, dist.group.WORLD)
    return opt.global_norm()


init_distributed("cpu")
rank, n = dist.get_rank(), dist.get_world_size()
mine = norm_params(stage_layers(LAYERS, n, rank))
out = {}
for moments in ("f32", "bf16"):
    out[moments] = (
        norm(mine, [k for k in mine if k.startswith("model.layers.")]),
        norm(norm_params(range(LAYERS))))
if rank == 0:
    torch.save(out, sys.argv[1])
"""


@pytest.fixture(scope="module")
def stage_norms(tmp_path_factory):
    """Rank 0's clipping norm with 2 stages a rank and one process's over
    every layer, by the moments' dtype."""
    tmp = tmp_path_factory.mktemp("norm")
    (tmp / "norm.py").write_text(NORM_SCRIPT)
    launch([str(tmp / "norm.py"), str(tmp / "norm.pt")], RANKS,
           timeout=LAUNCH_S)
    return torch.load(tmp / "norm.pt", weights_only=True)


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_stage_norm_equals_one_process(stage_norms, moments):
    got, want = stage_norms[moments]
    assert got.dtype == want.dtype and torch.equal(got, want), (got, want)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

COMMON = ["--device", "cpu", "--synthetic", "--model_size", "tiny",
          "--epochs", "2", "--steps_per_epoch", "1", "--num_workers", "1",
          "--warmup_steps", "0", "--lr", "1e-3", "--seed", "42",
          "--val_mode", "loss", "--pipeline_microbatches", "2"]
DATA_PARALLEL = ["-m", "grove_tpu_torch.train.driver", "--multihost",
                 *COMMON, "--batch_size", str(LOCAL)]
PIPELINED = [*DATA_PARALLEL, "--pipeline_stages", str(RANKS)]


def _ckpt(root, step=2):
    return torch.load(root / "grove_tpu" / "ckpt_model" / str(step) /
                      "state.pt", weights_only=True)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _assert_close(got, want):
    """`tests/test_torch_distributed_driver.py`'s rule: every tensor within
    CKPT_TOL, but for the few whose gradient is zero up to rounding (a
    first moment below ZERO_GRAD of the largest), held to that."""
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
                                       w.float().numpy(), rtol=CKPT_TOL,
                                       atol=CKPT_TOL, err_msg=k)
        else:
            assert got[k] == w, k


def _val_losses(out):
    return [float(v) for v in re.findall(r"val: val_loss=(\S+)", out)]


def _together(*argvs):
    """Each of `argvs` launched on RANKS ranks, the launches at once; each
    one's outputs."""
    with ThreadPoolExecutor(len(argvs)) as pool:
        return list(pool.map(
            lambda argv: launch(argv, RANKS, timeout=LAUNCH_S), argvs))


def test_pipelined_driver_matches_world1_and_resumes(tmp_path):
    """Against data parallelism on the same shards (world 1 reads other
    batches: each rank draws its rows' question templates from its own
    generator, as in the JAX package)."""
    dp, pp = tmp_path / "dp", tmp_path / "pp"
    want, outs = _together([*DATA_PARALLEL, "--log_base_dir", str(dp)],
                           [*PIPELINED, "--log_base_dir", str(pp)])
    assert all("training done: 2 steps" in o for o in outs)
    assert "2 stages x 1 layers, one a rank" in outs[0]
    assert "over gloo" in outs[0]
    want_val = _val_losses(want[0])
    assert len(want_val) == 2
    np.testing.assert_allclose(_val_losses(outs[0]), want_val, atol=2e-4)
    _assert_close(_ckpt(pp), _ckpt(dp))

    # resumed from step 1: each rank's layers and moments restored bit for
    # bit; the dataset's sampling generator starts anew with the process,
    # so the step after a resume is held to data parallelism's resumed the
    # same way
    for root in (dp, pp):
        shutil.copytree(root, f"{root}_resumed")
        shutil.rmtree(tmp_path / f"{root.name}_resumed" / "grove_tpu" /
                      "ckpt_model" / "2")
    _, outs = _together(
        [*DATA_PARALLEL, "--auto_resume", "--log_base_dir",
         str(tmp_path / "dp_resumed")],
        [*WORKER, "driver", json.dumps(dict(
            argv=PIPELINED[2:] + ["--auto_resume", "--log_base_dir",
                                  str(tmp_path / "pp_resumed")],
            state_out=str(tmp_path / "restored.pt"), device="cpu"))])
    assert "resumed from step 1 (epoch 1)" in outs[0]
    restored = _flat(torch.load(tmp_path / "restored.pt", weights_only=True))
    saved = _flat(_ckpt(pp, 1))
    saved = {k: v for k, v in saved.items() if not k.startswith("extra")}
    assert set(restored) == set(saved)
    for k, v in saved.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(restored[k], v), k
        else:
            assert restored[k] == v, k
    _assert_close(_ckpt(tmp_path / "pp_resumed"),
                  _ckpt(tmp_path / "dp_resumed"))


def test_pipeline_world_must_be_the_stage_count(tmp_path):
    with pytest.raises(RuntimeError, match=r"--pipeline_stages 4 across "
                       r"processes runs one stage a rank: the world holds "
                       r"2 processes, not 4"):
        launch(["-m", "grove_tpu_torch.train.driver", "--multihost",
                "--pipeline_stages", "4", *COMMON[:-2],
                "--log_base_dir", str(tmp_path)], RANKS, timeout=LAUNCH_S)


def test_pipeline_and_tensor_parallelism_exclude_each_other(tmp_path):
    with pytest.raises(ValueError, match="mutually exclusive"):
        driver.main(COMMON + ["--multihost", "--mesh_model", "2",
                              "--pipeline_stages", "2", "--log_base_dir",
                              str(tmp_path)])
