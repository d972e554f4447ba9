"""What each quality protocol trains from, on the CPU with the real code at
small widths (``load_state`` gives fresh optimizers, so each protocol
takes its own way, as its JAX script does):

- ``streaming_finetune_eval`` continues the e2e run's saved train state:
  its Adam moments and step count (``utils/checkpoint.py::restore``), to
  ``state.step + --steps``; the checkpoint it writes carries Adam's step
  count on from there and the fine-tune's learning rate;
- ``streaming_native_train`` starts a fresh ``init_state`` (seed ``--seed``,
  31) at step 0 with fresh optimizers, holding the workdir's AM and, with
  ``--init trained``, its G and D (``--init scratch``: the seed's G);
- ``am_streaming_finetune`` (seed 17) and ``coadapt_alternate`` (seed 23)
  take the AM and G into a fresh ``init_state`` of their objective (``am``,
  ``acoustic``): step 0, fresh SGD / Adam, the trained network trainable and
  the other frozen.
"""

import json

import pytest
import torch

from aas_enhancement_tpu_torch.config import (AMConfig, Config, DataConfig,
                                              DiscriminatorConfig, EnhancerConfig, TrainConfig)
from aas_enhancement_tpu_torch.data.synthetic import generate_corpus
from aas_enhancement_tpu_torch.quality import (am_streaming_finetune, coadapt_alternate,
                                               streaming_finetune_eval, streaming_native_train)
from aas_enhancement_tpu_torch.train import loop as tloop
from aas_enhancement_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

SAVED_STEP = 2


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """An e2e workdir in the port's layout: a small AAS run's train state
    after 2 steps (Adam moments non-zero) in ``checkpoint/``, and
    ``sweep_state.json``."""
    root = tmp_path_factory.mktemp("quality_state")
    corpora = {split: generate_corpus(str(root / split), n_utts=4, seed=seed, n_words=(2, 4))
               for split, seed in (("corpus", 7), ("corpus_dev", 8), ("corpus_test", 9))}
    cfg = Config(
        am=AMConfig(rnn_hidden=16, rnn_layers=2, conv_channels=8),
        enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=12, rnn_layers=1),
        discriminator=DiscriminatorConfig(channels=(8, 16)),
        train=TrainConfig(objective="aas", batch_size=2, epochs=100000, log_every=25),
        data=DataConfig(num_buckets=1))
    train, dev, test = (corpora[k] for k in ("corpus", "corpus_dev", "corpus_test"))
    state, _ = tloop.train(cfg, train["noisy"], train["clean"], max_steps=SAVED_STEP,
                           state=tloop.init_state(cfg, 1, "cpu"), device="cpu")
    ck = root / "checkpoint"
    ck.mkdir()
    (ck / "config.json").write_text(cfg.to_json())
    ckpt.save(str(ck), state.step, state)
    with open(root / "sweep_state.json", "w") as f:
        json.dump({"checkpoint": str(ck), "test_noisy": test["noisy"],
                   "test_clean": test["clean"], "dev_noisy": dev["noisy"],
                   "train_noisy": train["noisy"], "train_clean": train["clean"]}, f)
    return root


def _same(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def _spy(monkeypatch, module, stop: bool = True) -> dict:
    """Record ``init_state``'s seed and the state ``train`` gets; stop there
    unless ``stop`` is False."""
    seen: dict = {}
    real_init, real_train = getattr(module, "init_state", None), module.train

    def init_state(cfg, seed, device="cuda"):
        seen["seed"] = seed
        return real_init(cfg, seed, device)

    def train(cfg, *manifests, max_steps=0, state=None, device="cuda"):
        seen.update(cfg=cfg, state=state, max_steps=max_steps,
                    opt={k: {n: t.clone() for n, t in _moments(getattr(state, k)).items()}
                         for k in ("g_opt", "d_opt", "am_opt") if getattr(state, k)})
        if stop:
            raise _Stop
        return real_train(cfg, *manifests, max_steps=max_steps, state=state, device=device)

    if real_init is not None:
        monkeypatch.setattr(module, "init_state", init_state)
    monkeypatch.setattr(module, "train", train)
    return seen


def _moments(opt) -> dict:
    """An optimizer's per-parameter state, flattened: {"i.key": tensor}."""
    return {f"{i}.{k}": v for i, s in opt.state_dict()["state"].items() for k, v in s.items()}


def test_finetune_eval_continues_the_saved_optimizers(workdir, monkeypatch, tmp_path):
    seen = _spy(monkeypatch, streaming_finetune_eval, stop=False)
    result = streaming_finetune_eval.main(
        ["--workdir", str(workdir), "--steps", "1", "--batch-size", "2", "--device", "cpu",
         "--save-checkpoint", str(tmp_path / "ck_stream_ft"), "--out",
         str(tmp_path / "r.json")])
    saved = ckpt.read(str(workdir / "checkpoint"), SAVED_STEP)
    state = seen["state"]
    assert seen["max_steps"] == SAVED_STEP + 1
    for k in ("g_opt", "d_opt"):
        want = {f"{i}.{n}": v for i, s in saved[k]["state"].items() for n, v in s.items()}
        assert want and seen["opt"][k].keys() == want.keys()
        for n, v in want.items():
            assert torch.equal(seen["opt"][k][n], v), (k, n)
    assert state.step == SAVED_STEP + 1
    blob = ckpt.read(str(tmp_path / "ck_stream_ft"), SAVED_STEP + 1)
    cfg = seen["cfg"]
    assert cfg.train.streaming_finetune and cfg.train.lr_g == pytest.approx(
        saved_lr_g(workdir) * 0.5)
    for k, lr in (("g_opt", cfg.train.lr_g), ("d_opt", cfg.train.lr_d)):
        assert {float(s["step"]) for s in blob[k]["state"].values()} == {SAVED_STEP + 1.0}
        assert blob[k]["param_groups"][0]["lr"] == pytest.approx(lr)
    loaded, loaded_cfg = tloop.load_state(result["checkpoint_dir"], "cpu")
    assert loaded.step == SAVED_STEP + 1 and loaded_cfg.train.streaming_finetune


def saved_lr_g(workdir) -> float:
    return tloop.load_state(str(workdir / "checkpoint"), "cpu")[1].train.lr_g


@pytest.mark.parametrize("init", ["trained", "scratch"])
def test_native_train_fresh_state_from_seed_31(init, workdir, monkeypatch):
    seen = _spy(monkeypatch, streaming_native_train)
    with pytest.raises(_Stop):
        streaming_native_train.main(["--workdir", str(workdir), "--init", init, "--steps", "1",
                                     "--batch-size", "2", "--device", "cpu"])
    base, _ = tloop.load_state(str(workdir / "checkpoint"), "cpu")
    state = seen["state"]
    assert seen["seed"] == 31 and state.step == 0
    assert not seen["opt"]["g_opt"] and not seen["opt"]["d_opt"]      # fresh Adam
    assert _same(state.am, base.am) and not any(p.requires_grad for p in state.am.parameters())
    fresh = tloop.init_state(seen["cfg"], 31, "cpu")
    for name in ("g", "d"):
        assert all(p.requires_grad for p in getattr(state, name).parameters())
        assert _same(getattr(state, name), getattr(base if init == "trained" else fresh, name))
        assert not _same(getattr(state, name), getattr(fresh if init == "trained" else base,
                                                       name))


@pytest.mark.parametrize("case", ["am_streamed", "am_offline", "coadapt"])
def test_fine_tunes_take_weights_into_a_fresh_init_state(case, workdir, monkeypatch):
    module = coadapt_alternate if case == "coadapt" else am_streaming_finetune
    seen = _spy(monkeypatch, module)
    argv = ["--workdir", str(workdir), "--steps", "1", "--batch-size", "2", "--device", "cpu"]
    if case == "coadapt":
        argv += ["--am-checkpoint", str(workdir / "checkpoint")]
    elif case == "am_offline":
        argv += ["--offline"]
    with pytest.raises(_Stop):
        module.main(argv)
    base, _ = tloop.load_state(str(workdir / "checkpoint"), "cpu")
    state = seen["state"]
    assert state.step == 0 and _same(state.am, base.am) and _same(state.g, base.g)
    trained, frozen = ("g", "am") if case == "coadapt" else ("am", "g")
    assert seen["seed"] == (23 if case == "coadapt" else 17)
    assert seen["cfg"].train.objective == ("acoustic" if case == "coadapt" else "am")
    assert list(seen["opt"]) == [f"{trained}_opt"] and not seen["opt"][f"{trained}_opt"]
    assert all(p.requires_grad for p in getattr(state, trained).parameters())
    assert not any(p.requires_grad for p in getattr(state, frozen).parameters())
