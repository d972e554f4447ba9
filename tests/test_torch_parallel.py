"""Data parallelism of the port (aas_enhancement_tpu_torch/parallel/mesh.py):
2 gloo processes on the CPU against 1 process, and against the JAX
package's 2-device mesh (tests/test_parallel.py's virtual CPU devices).

The ranks are spawned once for the module (``tests/torch_dp_worker.py``,
which imports no JAX) and run every job in one pair, joined through a file
store under the test's temporary directory, with a deadline: a rank that
fails or hangs fails the tests.  The 1-process references and the JAX mesh
run in this process meanwhile.

Limits (f32 on every side):
- step 1, 2 processes against 1: each metric rtol 1e-4 / atol 1e-5 (the
  JAX mesh test's); each gradient tensor within 1e-4 of its own max|g|
  (measured: up to 1.7e-5, the enhancer's first conv weight, an f32 sum
  over 8 x 100 x 161 positions that cancel, summed as two halves of 4 rows
  here), and a tensor whose max|g| is below 1e-5 of its network's largest
  (zero to rounding: a conv bias in front of a GroupNorm has a true
  gradient of 0, and both sides give ~1e-7 there) within 1e-5 of the
  network's max|g|;
- steps 2-3: rtol 2e-2 / atol 1e-3 (the JAX mesh test's: Adam and SGD
  amplify rounding);
- the parameters after the last step are equal in the two ranks, bit for bit;
- the port on 2 processes against the JAX 2-device mesh at step 1: rtol
  1e-4 / atol 1e-6 (tests/test_torch_train.py's port-vs-JAX limit).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
import types

import jax
import numpy as np
import pytest
import torch

import test_parallel
import torch_dp_worker as worker
from aas_enhancement_tpu.config import (AMConfig, Config, DiscriminatorConfig,
                                        EnhancerConfig, MeshConfig, TrainConfig)
from aas_enhancement_tpu.parallel import mesh as jmesh
from aas_enhancement_tpu.train.loop import init_state as jax_init_state
from aas_enhancement_tpu.train.steps import make_train_step as jax_make_train_step
from aas_enhancement_tpu_torch.config import Config as TConfig
from aas_enhancement_tpu_torch.config import DataConfig as TDataConfig
from aas_enhancement_tpu_torch.config import MeshConfig as TMeshConfig
from aas_enhancement_tpu_torch.convert import (am_params_from_flax, disc_params_from_flax,
                                               enhancer_params_from_flax)
from aas_enhancement_tpu_torch.data import generate_corpus
from aas_enhancement_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
WORLD = 2
DEADLINE_S = 600
STEP1 = dict(rtol=1e-4, atol=1e-5)
LATER = dict(rtol=2e-2, atol=1e-3)
GRAD_REL = 1e-4
GRAD_ZERO = 1e-5
JAX_RTOL = 1e-4
CONVERT = {"g": enhancer_params_from_flax, "d": disc_params_from_flax,
           "am": am_params_from_flax}

# The port's copy of tests/test_parallel.py::_MESH_VARIANTS (held to it below).
_BLOCKWISE = dict(stream_chunk_s=0.24, stream_lookahead_s=0.1,
                  stream_history_s=0.24)
MESH_VARIANTS = [
    ("aas", None),
    ("paired", None),
    ("acoustic", None),
    ("adversarial", None),
    ("am", None),
    ("aas-blockwise", dict(streaming_finetune=True, **_BLOCKWISE)),
    ("am-livechain", dict(am_through_enhancer=True, streaming_finetune=True,
                          streaming_finetune_am=True, **_BLOCKWISE)),
]


def _jax_cfg(objective, n_devices, train=None, batch_size=8):
    return Config(
        am=AMConfig(rnn_hidden=16, rnn_layers=1, conv_channels=8),
        enhancer=EnhancerConfig(conv_channels=8, conv_layers=1,
                                rnn_hidden=16, rnn_layers=1),
        discriminator=DiscriminatorConfig(channels=(8, 16)),
        train=TrainConfig(objective=objective, batch_size=batch_size, **(train or {})),
        mesh=MeshConfig(num_devices=n_devices))


def _port_cfg(objective, n_devices, train=None, batch_size=8):
    return _jax_cfg(objective, n_devices, train, batch_size).to_json()


def _batch(b=8, seed=0, weights=None):
    batch = test_parallel._batch(b=b, seed=seed)
    if weights is not None:
        batch["row_weights"] = np.asarray(weights, np.float32)
    return batch


def _jobs(n_devices, jax_states):
    """Every job of the module, for a run over ``n_devices`` processes."""
    jobs = []
    for variant, overrides in MESH_VARIANTS:
        jobs.append({"name": variant, "steps": 3, "grads": True, "batch": _batch(),
                     "cfg": _port_cfg(variant.split("-")[0], n_devices, overrides)})
    # 5 real rows of 6: with 2 ranks and k = 2 the batch pads to 8 rows and
    # rank 1 holds 1 real row of 4, so a rank-local denominator would show.
    k = 2 if n_devices > 1 else 1
    jobs.append({"name": "accum", "steps": 3, "grads": True,
                 "batch": _batch(b=6, seed=1, weights=[1, 1, 1, 1, 1, 0]),
                 "cfg": _port_cfg("aas", n_devices, dict(grad_accum=k), batch_size=6)})
    for k in (1, 2):
        jobs.append({"name": f"spec_augment_k{k}", "steps": 3, "grads": True,
                     "batch": _batch(seed=2),
                     "cfg": _port_cfg("am", n_devices, dict(spec_augment=True,
                                                            grad_accum=k))})
    for objective, sd in jax_states.items():
        jobs.append({"name": f"jax_{objective}", "steps": 1, "grads": False,
                     "batch": _batch(seed=3), "state": sd,
                     "cfg": _port_cfg(objective, n_devices)})
    return jobs


def _jax_init(objective):
    """(the JAX state, its networks as the port's state_dicts)."""
    jstate = jax_init_state(_jax_cfg(objective, WORLD), jax.random.key(0))
    nets = ("am",) if objective == "am" else ("g", "d", "am")
    return jstate, {net: CONVERT[net](jax.device_get(getattr(jstate, f"{net}_params")))
                    for net in nets}


def _jax_mesh_step1(objective, jstate):
    """Step-1 metrics of the JAX step on a 2-device mesh
    (tests/test_parallel.py::_run's path)."""
    cfg = _jax_cfg(objective, WORLD)
    mesh = jmesh.make_mesh(cfg.mesh)
    assert len(mesh.devices.ravel()) == WORLD
    state = jmesh.replicate_state(mesh, jstate)
    step = jax.jit(jax_make_train_step(cfg))
    with mesh:
        _, aux = step(state, jmesh.shard_batch(
            mesh, jmesh.pad_batch_to_devices(_batch(seed=3), WORLD)))
    return {k: float(v) for k, v in aux.items()}


def _spawn_ranks(tmp, jobs):
    torch.save(jobs, os.path.join(tmp, "jobs.pt"))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    procs = []
    for r in range(WORLD):
        log = open(os.path.join(tmp, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, os.path.join(tmp, "jobs.pt"),
             os.path.join(tmp, "store"), str(r), str(WORLD), os.path.join(tmp, f"out{r}.pt")],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _join_ranks(tmp, procs):
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    codes = [p.returncode for p, _ in procs]
    if codes != [0] * WORLD:
        logs = [open(os.path.join(tmp, f"rank{r}.log")).read()[-3000:] for r in range(WORLD)]
        pytest.fail(f"ranks exited {codes} (killed at the {DEADLINE_S} s deadline if "
                    f"negative):\n" + "\n---\n".join(logs))
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": [rank 0's, rank 1's results], "one": the 1-process run's,
    "jax": {objective: JAX mesh step-1 metrics}}."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    inits = {objective: _jax_init(objective) for objective in ("aas", "am")}
    jax_states = {objective: sd for objective, (_, sd) in inits.items()}
    procs = _spawn_ranks(tmp, _jobs(WORLD, jax_states))
    try:        # while the ranks run
        jax_out = {objective: _jax_mesh_step1(objective, jstate)
                   for objective, (jstate, _) in inits.items()}
        one = worker.run_jobs(_jobs(1, jax_states), tmesh.make_mesh(TMeshConfig(), "cpu"))
    finally:
        ranks = _join_ranks(tmp, procs)
    return {"ranks": ranks, "one": one, "jax": jax_out}


def _assert_grads(got, ref, what):
    assert set(got) == set(ref), what
    for net, named in ref.items():
        scale = max(float(g.abs().max()) for g in named.values())
        assert set(got[net]) == set(named)
        for n, g in named.items():
            tmax = float(g.abs().max())
            atol = GRAD_REL * tmax if tmax >= GRAD_ZERO * scale else GRAD_ZERO * scale
            np.testing.assert_allclose(got[net][n].numpy(), g.numpy(), rtol=0, atol=atol,
                                       err_msg=f"{what}: {net} {n}")


def _assert_matches_one_process(runs, name, ref_name=None):
    ref = runs["one"][ref_name or name]
    for rank, res in enumerate(runs["ranks"]):
        got = res[name]
        assert len(got["aux"]) == len(ref["aux"])
        for i, (a, r) in enumerate(zip(got["aux"], ref["aux"])):
            assert set(a) == set(r)
            for key in r:
                np.testing.assert_allclose(a[key], r[key], **(STEP1 if i == 0 else LATER),
                                           err_msg=f"{name} rank {rank} step {i + 1} {key}")
        if "grads" in ref:
            _assert_grads(got["grads"], ref["grads"], f"{name} rank {rank}")
    p0, p1 = (res[name]["params"] for res in runs["ranks"])
    for net in p0:
        for n in p0[net]:
            assert torch.equal(p0[net][n], p1[net][n]), f"{name}: {net} {n} differs by rank"


def test_variant_list_is_the_jax_one():
    assert MESH_VARIANTS == test_parallel._MESH_VARIANTS


@pytest.mark.parametrize("variant", [v[0] for v in MESH_VARIANTS])
def test_two_processes_match_one(runs, variant):
    """Same init, same global batch: 2 gloo processes (4 rows each, the
    gradients summed by one all-reduce a network) track the 1-process run
    over 3 steps, and the ranks hold the same parameters."""
    _assert_matches_one_process(runs, variant)


def test_grad_accum_on_two_processes_matches_one_process_unaccumulated(runs):
    """grad_accum 2 on 2 processes (the padding's zero-weight rows all on
    rank 1) against k = 1 on 1 process: each loss term divides by the global
    real-row weight, so the gradients are the same."""
    _assert_matches_one_process(runs, "accum")


@pytest.mark.parametrize("k", [1, 2])
def test_spec_augment_stripes_follow_the_global_rows(runs, k):
    """``am`` with SpecAugment: each rank draws for the global microbatch and
    keeps its rows, so every row gets the 1-process run's stripes (the
    step-1 losses agree to rounding, not just in distribution)."""
    _assert_matches_one_process(runs, f"spec_augment_k{k}")
    got, ref = runs["ranks"][0][f"spec_augment_k{k}"], runs["one"][f"spec_augment_k{k}"]
    assert got["aux"][0]["loss_ctc_am"] == pytest.approx(ref["aux"][0]["loss_ctc_am"],
                                                        rel=1e-6)


@pytest.mark.parametrize("objective", ["aas", "am"])
def test_two_processes_match_the_jax_mesh(runs, objective):
    """The port on 2 processes against the JAX package's step on a 2-device
    mesh, from the same (converted) weights and batch: step-1 metrics."""
    ref = runs["jax"][objective]
    for rank, res in enumerate(runs["ranks"]):
        got = res[f"jax_{objective}"]["aux"][0]
        assert set(got) == set(ref)
        for key, v in ref.items():
            assert got[key] == pytest.approx(v, rel=JAX_RTOL, abs=1e-6), (rank, key)


@pytest.mark.parametrize("b,n", [(5, 8), (2, 8), (8, 2), (3, 2)])
def test_padding_matches_jax(b, n):
    batch = _batch(b=b)
    got = tmesh.pad_batch_to_devices(batch, n)
    ref = jmesh.pad_batch_to_devices(batch, n)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])
        for r in range(n):
            np.testing.assert_array_equal(tmesh.process_local_rows(got[key], n, r),
                                          jmesh.process_local_rows(ref[key], n, r))


def test_indivisible_rows_raise_as_in_jax():
    v = np.zeros((5, 3), np.float32)
    for fn in (tmesh.process_local_rows, jmesh.process_local_rows):
        with pytest.raises(ValueError, match="not divisible by 2 processes"):
            fn(v, 2, 0)


@pytest.mark.parametrize("world,k", [(2, 2), (2, 1), (4, 2), (1, 2)])
def test_shard_batch_blocks_split_into_the_global_microbatches(world, k):
    """Each rank's block of the padded batch: padded rows weigh 0 (a stream
    without weights gets them), and the block's microbatch i holds the
    global rows r % k == i, in order, as the 1-process split does."""
    batch = _batch(b=6, weights=[1, 1, 0, 1, 1, 1])
    rows = -(-6 // (world * k)) * world * k
    blocks = [tmesh.shard_batch(tmesh.DataMesh(rank=r, world=world), batch, k)
              for r in range(world)]
    whole = {key: torch.cat([blk[key] for blk in blocks]) for key in blocks[0]}
    assert whole["wav"].shape[0] == rows
    assert whole["row_weights"].tolist() == [1, 1, 0, 1, 1, 1] + [0] * (rows - 6)
    if rows > 6:
        assert whole["clean_row_weights"].tolist() == [1] * 6 + [0] * (rows - 6)
    else:                                       # nothing padded: no weights added
        assert "clean_row_weights" not in whole
    for key, v in batch.items():
        np.testing.assert_array_equal(whole[key][:6].numpy(), v)
    for i in range(k):
        local = torch.cat([blk["wav"][i::k] for blk in blocks])
        torch.testing.assert_close(local, whole["wav"][i::k], rtol=0, atol=0)


def test_mesh_config_must_match_the_world(monkeypatch):
    """mesh.num_devices other than 0 must equal the processes launched (the
    JAX make_mesh refuses more devices than it sees), before any group."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    one = tmesh.make_mesh(TMeshConfig(num_devices=1), "cpu")
    assert (one.world, one.distributed, one.device.type) == (1, False, "cpu")
    assert not tmesh.make_mesh(TMeshConfig(), "cpu").distributed
    with pytest.raises(ValueError, match=r"num_devices = 2 but 1 process"):
        tmesh.make_mesh(TMeshConfig(num_devices=2), "cpu")
    with pytest.raises(ValueError, match=r"num_devices = 3 but 2 process"):
        tmesh.make_mesh(TMeshConfig(num_devices=3), "cpu", rank=0, world_size=2)
    with pytest.raises(ValueError, match="requested 9 devices"):
        jmesh.make_mesh(MeshConfig(num_devices=9))    # JAX: more than it sees
    assert TConfig.from_json(_jax_cfg("aas", 2).to_json()).mesh == TMeshConfig(num_devices=2)


@pytest.mark.parametrize("device,rank", [("cuda:0", 1), ("cuda:0", 0), ("cpu", 0)])
def test_nccl_refuses_ranks_that_share_a_card(device, rank, monkeypatch):
    """nccl with two ranks on one card (or on the CPU) raises before any
    process group, naming gloo."""
    for key in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="gloo"):
        tmesh.make_mesh(TMeshConfig(), device, backend="nccl", rank=rank, world_size=2)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("rank", [0, 1])
def test_replicate_state_refuses_ranks_at_other_steps(rank):
    """Rank 0 restored step 2, rank 1 step 0 (a checkpoint directory that
    rank 1 does not see): every rank raises, before any parameter moves.
    The collectives are those of rank ``rank`` of 2."""
    steps = [2, 0]

    class TwoRanks(tmesh.DataMesh):
        def broadcast_(self, t, src=0):
            moved.append(t.dtype)
            return t.fill_(steps[src])

        def all_reduce_(self, t):
            return t.add_(int(steps[1 - self.rank] != steps[0]))

    moved = []
    mesh = TwoRanks(rank=rank, world=2, group=object())
    state = types.SimpleNamespace(step=steps[rank], g=torch.nn.Linear(2, 2), d=None, am=None)
    with pytest.raises(RuntimeError, match="every rank sees"):
        tmesh.replicate_state(mesh, state)
    assert moved == [torch.int64]          # the step's broadcast, no parameter's


def test_all_reduce_grads_is_a_no_op_in_one_process():
    mesh = tmesh.DataMesh()
    grads = {"g": {"w": torch.ones(3)}}
    aux = {"loss": torch.tensor(2.0)}
    assert tmesh.all_reduce_grads(mesh, grads, aux) == (grads, aux)


# ------------------------------------------------------------- the CLI


def torchrun(args: list[str], nproc: int = WORLD, timeout: float = 300
             ) -> subprocess.CompletedProcess:
    """``torchrun --standalone --nproc_per_node nproc -m <the train CLI> args``."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node", str(nproc), "-m",
                        "aas_enhancement_tpu_torch.cli.train", *args],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r


def small_config(tmp_path, **mesh) -> str:
    cfg = TConfig.from_json(_port_cfg("aas", 0))
    cfg = cfg.replace(data=TDataConfig(num_buckets=1),
                      mesh=dataclasses.replace(cfg.mesh, **mesh),
                      train=dataclasses.replace(cfg.train, log_every=1,
                                                checkpoint_every=2))
    path = tmp_path / "small.json"
    path.write_text(cfg.to_json())
    return str(path)


def _json_lines(text: str) -> list[dict]:
    return [json.loads(s) for s in text.splitlines() if s.startswith("{")]


def test_cli_under_two_ranks_writes_once_and_resumes_exactly(tmp_path):
    """cli.train under torchrun, 2 gloo processes on the CPU: rank 0 alone
    prints the final line and the records and writes the checkpoint
    directory, the metrics file, best_ckpt/ and best.json; 2 steps saved,
    then --continue-from to step 4, equals 4 uninterrupted steps."""
    corpus = generate_corpus(str(tmp_path / "corpus"), n_utts=8, seed=2)
    base = ["--objective", "aas", "--noisy-manifest", corpus["noisy"],
            "--clean-manifest", corpus["clean"], "--am-checkpoint", "seed:0",
            "--batch-size", "4", "--device", "cpu", "--config", small_config(tmp_path)]
    ck, ck2 = str(tmp_path / "ck"), str(tmp_path / "ck2")
    r = torchrun([*base, "--steps", "4", "--checkpoint-dir", ck, "--metrics",
                  str(tmp_path / "m.jsonl"), "--val-manifest", corpus["noisy"],
                  "--eval-every", "2"])
    finals = [s for s in r.stdout.splitlines() if s.startswith('{"final_step"')]
    assert len(finals) == 1 and json.loads(finals[0])["final_step"] == 4
    lines = [json.loads(s) for s in open(tmp_path / "m.jsonl")]
    steps = [rec["step"] for rec in lines if "loss_g" in rec]
    assert steps == [1, 2, 3, 4]
    assert [rec["step"] for rec in _json_lines(r.stderr) if "loss_g" in rec] == steps
    assert sorted(os.listdir(ck)) == ["2", "4", "best.json", "best_ckpt", "config.json"]
    assert os.listdir(os.path.join(ck, "best_ckpt")) in (["2"], ["4"])

    torchrun([*base, "--steps", "2", "--checkpoint-dir", ck2])
    r2 = torchrun([*base, "--steps", "4", "--checkpoint-dir", ck2, "--continue-from"])
    resumed = {rec["step"]: rec for rec in _json_lines(r2.stderr)}
    assert sorted(resumed) == [3, 4]
    for rec in lines:
        if rec["step"] in resumed and "loss_g" in rec:
            got = resumed[rec["step"]]
            assert {k: v for k, v in got.items() if k.startswith("loss")} == \
                {k: v for k, v in rec.items() if k.startswith("loss")}
    a = torch.load(os.path.join(ck, "4", "state.pt"), weights_only=True)
    b = torch.load(os.path.join(ck2, "4", "state.pt"), weights_only=True)
    for net in ("g", "d"):
        for n, v in a[net].items():
            assert torch.equal(v, b[net][n]), (net, n)
