"""What the port's protocol tests share (test_torch_e2e.py,
test_torch_quality_*.py): a recorder that stands in for every package
function a JAX script or its port calls, the stubs that install it on
either side, a runner for a JAX script under test, and the trajectory
helpers that carry JAX's initial state across.

The recorder keeps each side's calls with their models named and their
paths made relative to the side's workdir.  Every stub returns a function of
the call count and its arguments only, so both sides get the same values
back, and the calls of the two sides can be compared as they are.

A network stands in as a tagged object: on the JAX side ``{"w": [code]}``,
on the port side a ``Linear(1, 1)`` whose weight is ``code``, with the code
a function of the network's name (``net_code``).  The name follows the
values, so it survives a pickle, ``load_state_dict`` into another module
and ``jax.device_get``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import pickle
import sys
import types
import zlib

import jax
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NAMES: dict[float, str] = {}


def net_code(name: str) -> float:
    """An integer-valued float (exact in f32) standing for ``name``."""
    code = float(1 + zlib.crc32(name.encode()) % 1_000_000)
    _NAMES[code] = name
    return code


def jax_net(name: str) -> dict:
    return {"w": np.full(1, net_code(name), np.float32)}


def port_net(name: str) -> torch.nn.Module:
    net = torch.nn.Linear(1, 1, bias=False)
    with torch.no_grad():
        net.weight.fill_(net_code(name))
    return net


def set_net(net: torch.nn.Module, name: str) -> None:
    """Give a port stand-in network (in place) the values of ``name``."""
    with torch.no_grad():
        net.weight.fill_(net_code(name))


def cfg_dict(cfg) -> dict:
    return json.loads(cfg.to_json())


@dataclasses.dataclass
class FakeJaxState:
    """A JAX ``TrainState`` stand-in: networks, step and an optimizer tag."""

    step: int = 0
    g_params: dict | None = None
    d_params: dict | None = None
    am_params: dict | None = None
    opt: str = "fresh"

    def replace(self, **kw) -> "FakeJaxState":
        return dataclasses.replace(self, **kw)


# The networks an objective's train step updates.
TRAINED = {"am": ("am",), "aas": ("g", "d"), "acoustic": ("g",)}


class Recorder:
    """The calls of one side, with its models named and its paths made
    relative to its workdir; every stub is a function of the call count and
    the arguments only, so both sides get the same values back."""

    def __init__(self, workdir: str):
        self.wd = str(workdir)
        self.calls: list[tuple] = []
        self.names: dict[int, str] = {}
        self.tagged: list = []       # alive, so that no other object takes a tagged id

    def tag(self, obj, name: str):
        self.names[id(obj)] = name
        self.tagged.append(obj)
        return obj

    def name(self, obj):
        if obj is None or (isinstance(obj, dict) and not obj):
            return None
        if id(obj) in self.names:
            return self.names[id(obj)]
        if isinstance(obj, str):
            return obj
        if isinstance(obj, dict) and "w" in obj:
            return _NAMES.get(float(np.asarray(obj["w"]).ravel()[0]), "?params")
        if isinstance(obj, torch.nn.Module):
            p = next(obj.parameters(), None)
            if p is not None:
                return _NAMES.get(float(p.detach().flatten()[0]), "?module")
        return f"?{type(obj).__name__}"

    def rel(self, path):
        return None if path is None else os.path.relpath(path, self.wd)

    def add(self, *call) -> int:
        self.calls.append(call)
        return len(self.calls)

    def view(self, state) -> tuple:
        """(step, G, D, AM, optimizers) of either side's train state."""
        if isinstance(state, FakeJaxState):
            nets, opt = (state.g_params, state.d_params, state.am_params), state.opt
        else:
            nets, opt = (state.g, state.d, state.am), getattr(state, "opt_tag", "?")
        return (int(state.step), *(self.name(n) for n in nets), opt)

    # -------------------------------------------------------- the e2e protocol
    def lm(self, kind: str, manifests, order=None):
        self.add("lm", kind, [self.rel(m) for m in manifests], order)
        return self.tag(types.SimpleNamespace(kind=kind), kind)

    def evaluate_wer(self, cfg, am, manifest, g, kw):
        n = self.add("evaluate_wer", cfg_dict(cfg), self.name(am), self.rel(manifest),
                     self.name(g), kw.get("batch_size"), kw.get("decoder", "greedy"),
                     kw.get("beam_width", 32), self.name(kw.get("lm")),
                     kw.get("lm_alpha", 0.0), kw.get("lm_beta", 0.0),
                     self.name(kw.get("word_lm")), kw.get("word_alpha", 0.0),
                     kw.get("word_beta", 0.0), self.name(kw.get("forward")),
                     kw.get("per_utt", False))
        out = {"wer": 0.01 * n, "wer_ci95": [0.001 * n, 0.02 * n],
               "sample_ref": f"ref {n}", "sample_hyp": f"hyp {n}"}
        if kw.get("per_utt"):
            out["per_utt"] = [(n + i) % 3 for i in range(5)]
        return out

    def grid_search_lm(self, cfg, am, dev, lm, g, kw):
        n = self.add("grid_search_lm", cfg_dict(cfg), self.name(am), self.rel(dev),
                     self.name(lm), self.name(g), kw.get("batch_size"), kw.get("beam_width"))
        kind = getattr(lm, "kind", None) or f"order{lm.order}"     # an ARPA file's LM
        alpha, beta = {"wlm": (0.6, 0.5), "clm": (1.5, -0.5), "order2": (0.6, 1.0),
                       "order3": (0.3, -0.5)}[kind]
        return {"alpha": alpha, "beta": beta, "wer": 0.1 * n, "wer_no_lm": 0.3}

    def grid_search_hybrid(self, cfg, am, dev, clm, wlm, g, kw):
        n = self.add("grid_search_hybrid", cfg_dict(cfg), self.name(am), self.rel(dev),
                     self.name(clm), self.name(wlm), self.name(g), kw.get("batch_size"),
                     kw.get("beam_width"))
        return {"alpha": 1.0, "beta": 0.0, "word_alpha": 0.3, "word_beta": 1.0,
                "wer": 0.05, "wer_char_only": 0.07, "wer_no_lm": 0.001 * n}

    def enhance_stream(self, cfg, g, samples):
        self.add("enhance_stream", cfg_dict(cfg), self.name(g), len(samples))
        h = len(samples) // 2
        return iter([0.5 * samples[:h], 0.5 * samples[h:], np.zeros(7, np.float32)])

    def evaluate_si_snr(self, cfg, noisy, clean, g, streamed):
        self.add("evaluate_si_snr", cfg_dict(cfg), self.rel(noisy), self.rel(clean),
                 self.name(g), self.rel(streamed))
        return {"si_snr_noisy": 1.0, "si_snr_enhanced": 3.5, "si_snr_streamed": 3.0,
                "stoi_noisy": 0.6, "stoi_enhanced": 0.7, "stoi_streamed": 0.65,
                "si_snr_improvement": 2.5}

    # ---------------------------------------------- the quality protocols
    def make_eval_forward(self, cfg, use_enhancer):
        self.add("make_eval_forward", cfg_dict(cfg), use_enhancer)
        return f"forward(enhancer={use_enhancer})"

    def init_nets(self, cfg, seed: int, make, am=None) -> dict:
        """The networks ``init_state`` builds for ``cfg``'s objective, named
        ``init<seed>.<net>`` (``am``, where given, in place of the AM)."""
        self.add("init_state", cfg_dict(cfg), seed)
        t = cfg.train
        names = (("am", "g") if t.am_through_enhancer else ("am",)) if t.objective == "am" \
            else ("g",) + (("d",) if t.objective in ("adversarial", "aas") else ()) \
            + (("am",) if t.objective in ("acoustic", "aas") else ())
        nets = {k: make(f"init{seed}.{k}") for k in names}
        if am is not None and "am" in nets:
            nets["am"] = am
        return nets

    def train(self, cfg, noisy, clean, max_steps, state) -> tuple[dict, list]:
        """-> (the trained networks' new names, the records)."""
        n = self.add("train", cfg_dict(cfg), self.rel(noisy), self.rel(clean), max_steps,
                     self.view(state))
        objective = cfg.train.objective
        ctc = "loss_ctc_am" if objective == "am" else "loss_ctc"
        recs = [{"step": 1, ctc: 200.0 + n, "loss_g": 30.0 + n},
                {"step": 2, "loss_d": 0.7},
                {"step": max_steps, ctc: 0.5 + n, "loss_g": 1.0 + n}]
        return {k: f"trained{n}.{k}" for k in TRAINED[objective]}, recs

    def load_state(self, directory) -> str:
        base = os.path.basename(os.path.normpath(directory))
        if self.rel(directory) == "checkpoint":
            self.add("load_workdir")
        else:
            self.add("load_state", self.rel(directory))
        return base

    def save(self, directory, step, state):
        self.add("save", self.rel(directory), int(step), self.view(state))

    def streaming_enhancer(self):
        rec = self

        class StreamingEnhancer:
            def __init__(self, cfg, g, chunk_seconds=1.0, lookahead_seconds=0.2,
                         history_seconds=1.0, device=None):
                assert device is None or torch.device(device) == torch.device("cpu")
                rec.add("StreamingEnhancer", cfg_dict(cfg), rec.name(g), chunk_seconds,
                        lookahead_seconds, history_seconds)
                self.n = 0

            def feed(self, samples):
                self.n = len(samples)
                return 0.5 * samples[: self.n // 2]

            def flush(self):       # past the input's end: the caller cuts it
                return np.full(self.n, 0.25, np.float32)

        return StreamingEnhancer

    def streaming_recognizer(self):
        rec = self

        class StreamingRecognizer:
            def __init__(self, cfg, am, g_params=None, enhancer=None, chunk_seconds=1.0,
                         lookahead_seconds=0.2, history_seconds=1.0, collect_logits=False,
                         device=None):
                assert device is None or torch.device(device) == torch.device("cpu")
                g = g_params if g_params is not None else enhancer
                rec.add("StreamingRecognizer", cfg_dict(cfg), rec.name(am), rec.name(g),
                        chunk_seconds, lookahead_seconds, history_seconds, collect_logits)
                self.fed: list[int] = []

            def feed(self, samples):
                self.fed.append(len(samples))
                return []

            def flush(self):
                rec.add("flush", self.fed)
                return []

            def transcript(self):
                return f"greedy {sum(self.fed)}"

            def log_probs(self):
                return np.full((1 + sum(self.fed) // 4000, 3), -1.0, np.float32)

        return StreamingRecognizer

    def beam_decode(self, log_probs, lengths=None, beam_width=32, prune_k=16, lm=None,
                    lm_alpha=0.0, lm_beta=0.0, word_lm=None, word_alpha=0.0, word_beta=0.0):
        self.add("beam_decode", tuple(log_probs.shape), lengths, beam_width, prune_k,
                 self.name(lm), lm_alpha, lm_beta, self.name(word_lm), word_alpha, word_beta)
        return [f"beam {lm_alpha} {lm_beta} {word_alpha} {word_beta}"] * log_probs.shape[0]

    def corpus_wer(self, refs, hyps) -> float:
        """0.5 for greedy transcripts; a beam's WER falls with both alphas
        (the char point at the grid's edge) and rises with |beta - 0.5| and
        word beta past 0.5: betas 0 and 1, word betas 0 and 0.5 tie, so a
        tuner that keeps ties shows."""
        self.add("corpus_wer", list(refs), list(hyps))
        if not hyps[0].startswith("beam"):
            return 0.5
        a, b, wa, wb = (float(x) for x in hyps[0].split()[1:])
        if a == 0.0:
            return 0.6
        return 0.4 - 0.05 * a + 0.02 * abs(b - 0.5) - 0.03 * wa + 0.01 * max(wb - 0.5, 0.0)

    def corpus_wer_ci(self, refs, hyps):
        w = self.corpus_wer(refs, hyps)
        return w, w - 0.1, w + 0.1

    def edge_refine(self, eval_fn, a0, b0, w0, alphas, betas, grid=None, a_key="alpha",
                    b_key="beta", max_evals=12):
        self.add("edge_refine", a0, b0, w0, list(alphas), list(betas), a_key, b_key)
        w = eval_fn(round(a0 + 0.5, 6), b0)
        return (round(a0 + 0.5, 6), b0, w) if w < w0 else (a0, b0, w0)

    # ---------------------------------------- the fusion protocols' CLIs
    def cli_argv(self, argv) -> list:
        """A CLI's argv with the paths under the workdir relative to it and
        the port's ``--device`` (the CPU here) taken out."""
        argv = list(argv)
        if "--device" in argv:
            i = argv.index("--device")
            assert argv[i + 1] == "cpu", argv
            del argv[i:i + 2]
        return [self.rel(a) if a.startswith(self.wd + os.sep) else a for a in argv]

    def cli_train(self, argv) -> None:
        """The train CLI: the call with its config file's fields; writes
        ``config.json`` into ``--checkpoint-dir`` (as both CLIs do) and its
        final JSON line."""
        opts = dict(zip(argv[::2], argv[1::2]))
        with open(opts["--config"]) as f:
            fields = json.load(f)
        self.add("cli.train", self.cli_argv(argv), fields)
        os.makedirs(opts["--checkpoint-dir"], exist_ok=True)
        with open(os.path.join(opts["--checkpoint-dir"], "config.json"), "w") as f:
            json.dump(fields, f)
        print(json.dumps({"final_step": int(opts["--steps"]), "loss_ctc_am": 0.5}))

    def cli_evaluate(self, argv) -> None:
        """The evaluate CLI: an advisory line, then its JSON line."""
        n = self.add("cli.evaluate", self.cli_argv(argv))
        print("advisory: the native decoder is in use")
        print(json.dumps({"noisy": {"wer": 0.001 * n, "utterances": n}}))

    def cache_log_probs(self, cfg, am, manifest, g, batch_size):
        self.add("cache_log_probs", cfg_dict(cfg), self.name(am), self.rel(manifest),
                 self.name(g), batch_size)
        return ["ref one", "ref two"], [np.zeros((4, 3), np.float32),
                                        np.zeros((6, 3), np.float32)]


# ---------------------------------------------------------------- installers

def install_jax(monkeypatch, rec: Recorder) -> None:
    """Every package function the JAX quality scripts call -> ``rec``."""
    from aas_enhancement_tpu import evaluation, streaming, streaming_asr
    from aas_enhancement_tpu.cli import evaluate as cli_evaluate
    from aas_enhancement_tpu.cli import train as cli_train
    from aas_enhancement_tpu.config import Config
    from aas_enhancement_tpu.decode.arpa import ArpaWordLM
    from aas_enhancement_tpu.train import loop
    from aas_enhancement_tpu.utils import checkpoint
    # the package's __init__ re-exports functions under some module names
    beam, lm, tune, wer = (importlib.import_module(f"aas_enhancement_tpu.decode.{m}")
                           for m in ("beam", "lm", "tune", "wer"))

    def init_state(cfg, rng, am_params=None):
        seed = int(np.asarray(jax.random.key_data(rng))[-1])
        nets = rec.init_nets(cfg, seed, jax_net, am_params)
        return FakeJaxState(**{f"{k}_params": v for k, v in nets.items()})

    def train(cfg, noisy, clean=None, max_steps=0, state=None, **kw):
        assert not kw
        names, recs = rec.train(cfg, noisy, clean, max_steps, state)
        return state.replace(step=max_steps, **{f"{k}_params": jax_net(v)
                                                for k, v in names.items()}), recs

    def load_state(directory):
        base = rec.load_state(directory)
        cfg_path = os.path.join(directory, "config.json")
        cfg = Config.from_json(open(cfg_path).read()) if os.path.exists(cfg_path) else None
        return FakeJaxState(step=7, **{f"{k}_params": jax_net(f"{base}.{k}")
                                       for k in ("g", "d", "am")}), cfg

    real_load = pickle.load

    def load_workdir(f, **kw):           # the scripts' only pickle: the workdir's
        rec.add("load_workdir")
        return real_load(f, **kw)

    monkeypatch.setattr(loop, "init_state", init_state)
    monkeypatch.setattr(loop, "train", train)
    monkeypatch.setattr(loop, "load_state", load_state)
    monkeypatch.setattr(pickle, "load", load_workdir)
    monkeypatch.setattr(evaluation, "make_eval_forward", rec.make_eval_forward)
    monkeypatch.setattr(evaluation, "evaluate_wer",
                        lambda cfg, am_params, manifest, g_params=None, **kw:
                        rec.evaluate_wer(cfg, am_params, manifest, g_params, kw))
    monkeypatch.setattr(streaming, "StreamingEnhancer", rec.streaming_enhancer())
    monkeypatch.setattr(streaming_asr, "StreamingRecognizer", rec.streaming_recognizer())
    monkeypatch.setattr(beam, "beam_decode", rec.beam_decode)
    monkeypatch.setattr(wer, "corpus_wer", rec.corpus_wer)
    monkeypatch.setattr(wer, "corpus_wer_ci", rec.corpus_wer_ci)
    monkeypatch.setattr(tune, "edge_refine", rec.edge_refine)
    monkeypatch.setattr(tune, "grid_search_lm",
                        lambda cfg, am_params, dev, lm, g_params=None, **kw:
                        rec.grid_search_lm(cfg, am_params, dev, lm, g_params, kw))
    monkeypatch.setattr(tune, "grid_search_hybrid",
                        lambda cfg, am_params, dev, clm, wlm, g_params=None, **kw:
                        rec.grid_search_hybrid(cfg, am_params, dev, clm, wlm, g_params, kw))
    monkeypatch.setattr(tune, "cache_log_probs",
                        lambda cfg, am_params, manifest, g_params=None, batch_size=8:
                        rec.cache_log_probs(cfg, am_params, manifest, g_params, batch_size))
    monkeypatch.setattr(lm.WordNGramLM, "from_manifests",
                        classmethod(lambda cls, paths: rec.lm("wlm", paths)))
    monkeypatch.setattr(lm.CharNGramLM, "from_manifests",
                        classmethod(lambda cls, paths, order=3: rec.lm("clm", paths, order)))
    monkeypatch.setattr(checkpoint, "make_manager",
                        lambda directory, max_to_keep=3:
                        types.SimpleNamespace(directory=directory, close=lambda: None))
    monkeypatch.setattr(checkpoint, "save",
                        lambda mgr, step, state: rec.save(mgr.directory, step, state))
    monkeypatch.setattr(cli_train, "main", rec.cli_train)
    monkeypatch.setattr(cli_evaluate, "main", rec.cli_evaluate)
    name_arpa_lms(monkeypatch, rec, ArpaWordLM)


def install_port(monkeypatch, rec: Recorder, module) -> None:
    """Every package function a port quality module (and ``quality/
    workdir.py``) calls -> ``rec``."""
    from aas_enhancement_tpu_torch.cli import evaluate as cli_evaluate
    from aas_enhancement_tpu_torch.cli import train as cli_train
    from aas_enhancement_tpu_torch.config import Config
    from aas_enhancement_tpu_torch.decode import lm
    from aas_enhancement_tpu_torch.decode.arpa import ArpaWordLM
    from aas_enhancement_tpu_torch.quality import workdir
    from aas_enhancement_tpu_torch.train.state import TrainState
    from aas_enhancement_tpu_torch.utils import checkpoint

    def cpu(device):
        assert torch.device(device) == torch.device("cpu"), device

    def state_of(nets: dict, step: int = 0, opt: str = "fresh") -> TrainState:
        state = TrainState(step=step, **nets)
        state.opt_tag = opt
        return state

    def init_state(cfg, seed, device="cuda"):
        cpu(device)
        return state_of(rec.init_nets(cfg, seed, port_net))

    def train(cfg, noisy, clean=None, max_steps=0, state=None, device="cuda"):
        cpu(device)
        names, recs = rec.train(cfg, noisy, clean, max_steps, state)
        for k, v in names.items():
            set_net(getattr(state, k), v)
        state.step = max_steps
        return state, recs

    def load_state(directory, device="cuda"):
        cpu(device)
        base = rec.load_state(directory)
        cfg_path = os.path.join(directory, "config.json")
        cfg = Config.from_json(open(cfg_path).read()) if os.path.exists(cfg_path) else None
        step = 5 if base == "checkpoint" else 7
        return state_of({k: port_net(f"{base}.{k}") for k in ("g", "d", "am")}, step), cfg

    def restore(directory, step, state):        # the workdir's saved optimizers
        assert rec.rel(directory) == "checkpoint" and step == state.step
        state.opt_tag = "saved"
        return state

    stubs = {
        "init_state": init_state, "train": train, "load_state": load_state,
        "make_eval_forward": rec.make_eval_forward,
        "evaluate_wer": lambda cfg, am, manifest, enhancer=None, **kw:
            rec.evaluate_wer(cfg, am, manifest, enhancer, kw),
        "StreamingEnhancer": rec.streaming_enhancer(),
        "StreamingRecognizer": rec.streaming_recognizer(),
        "beam_decode": rec.beam_decode, "corpus_wer": rec.corpus_wer,
        "corpus_wer_ci": rec.corpus_wer_ci, "edge_refine": rec.edge_refine,
        "grid_search_lm": lambda cfg, am, dev, lm, enhancer=None, **kw:
            rec.grid_search_lm(cfg, am, dev, lm, enhancer, kw),
        "grid_search_hybrid": lambda cfg, am, dev, clm, wlm, enhancer=None, **kw:
            rec.grid_search_hybrid(cfg, am, dev, clm, wlm, enhancer, kw),
        "cache_log_probs": lambda cfg, am, manifest, enhancer=None, batch_size=8:
            rec.cache_log_probs(cfg, am, manifest, enhancer, batch_size),
    }
    for mod in (module, workdir):
        for name, stub in stubs.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, stub)
    monkeypatch.setattr(checkpoint, "restore", restore)
    monkeypatch.setattr(checkpoint, "save",
                        lambda directory, step, state, max_to_keep=3:
                        rec.save(directory, step, state))
    monkeypatch.setattr(lm.WordNGramLM, "from_manifests",
                        classmethod(lambda cls, paths: rec.lm("wlm", paths)))
    monkeypatch.setattr(lm.CharNGramLM, "from_manifests",
                        classmethod(lambda cls, paths, order=3: rec.lm("clm", paths, order)))
    monkeypatch.setattr(cli_train, "main", rec.cli_train)
    monkeypatch.setattr(cli_evaluate, "main", rec.cli_evaluate)
    name_arpa_lms(monkeypatch, rec, ArpaWordLM)


def name_arpa_lms(monkeypatch, rec: Recorder, cls) -> None:
    """Every ARPA LM read from a file named by the file and its order."""
    load = cls.load_arpa

    def load_arpa(klass, path, *args, **kw):
        lm = load(path, *args, **kw)
        return rec.tag(lm, f"{rec.rel(path)} (order {lm.order})")

    monkeypatch.setattr(cls, "load_arpa", classmethod(load_arpa))


def norm_paths(obj, wd: str):
    """``obj`` with the workdir's path written WD."""
    if isinstance(obj, dict):
        return {k: norm_paths(v, wd) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(norm_paths(v, wd) for v in obj)
    return obj.replace(wd, "WD") if isinstance(obj, str) else obj


def written_files(wd, skip, drop=("wall_minutes",)) -> dict:
    """Every file under ``wd`` but ``skip``: JSON as dicts (the ``drop``
    keys aside), other files as bytes, with the workdir's path written WD."""
    out = {}
    for root, _, files in os.walk(wd):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, wd)
            if rel in skip:
                continue
            data = open(path, "rb").read().replace(str(wd).encode(), b"WD")
            if name.endswith(".json"):
                data = json.loads(data)
                for key in drop:
                    data.pop(key, None)
            out[rel] = data
    return out


def load_jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", os.path.join(REPO, "scripts", f"{name}.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def run_jax_script(monkeypatch, tmp_path, script, argv) -> None:
    """``script.main()`` with ``argv``, its compilation cache in ``tmp_path``
    and JAX's cache settings restored after."""
    monkeypatch.setenv("AAS_XLA_CACHE", str(tmp_path / "xla_cache"))
    monkeypatch.setattr(sys, "argv", [f"{script.__name__}.py", *argv])
    kept = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                 "jax_persistent_cache_min_compile_time_secs")}
    try:
        script.main()
    finally:
        for k, v in kept.items():
            jax.config.update(k, v)


def small_e2e_config(objective: str, batch_size: int, lambda_adv: float):
    """``cli/e2e.py::cfg_for`` cut to small widths (AM 2 x BiGRU-16, 8
    channels; enhancer 1 conv layer, 1 x BiLSTM-12; discriminator (8, 16)),
    for real protocol runs on the CPU."""
    from aas_enhancement_tpu_torch.config import (AMConfig, Config, DataConfig,
                                                  DiscriminatorConfig, EnhancerConfig,
                                                  TrainConfig)
    return Config(
        am=AMConfig(rnn_hidden=16, rnn_layers=2, conv_channels=8),
        enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=12, rnn_layers=1),
        discriminator=DiscriminatorConfig(channels=(8, 16)),
        train=TrainConfig(objective=objective, batch_size=batch_size, epochs=100000,
                          log_every=25, lr_am=6e-4, lr_g=3e-4, lr_d=3e-4,
                          lambda_adv=lambda_adv),
        data=DataConfig(num_buckets=2))


# ---------------------------------------------------------------- trajectories

def _nets():
    from aas_enhancement_tpu_torch.convert import (am_params_from_flax, disc_params_from_flax,
                                                   enhancer_params_from_flax)
    from aas_enhancement_tpu_torch.models.am import AcousticModel
    from aas_enhancement_tpu_torch.models.discriminator import Discriminator
    from aas_enhancement_tpu_torch.models.enhancer import Enhancer
    return {"g": (Enhancer, "enhancer", enhancer_params_from_flax),
            "d": (Discriminator, "discriminator", disc_params_from_flax),
            "am": (AcousticModel, "am", am_params_from_flax)}


def port_params(jstate) -> dict[str, dict[str, torch.Tensor]]:
    """A JAX train state's networks as the port's ``state_dict``s."""
    out = {}
    for name, (_, _, convert) in _nets().items():
        params = getattr(jstate, f"{name}_params")
        if params:
            out[name] = convert(jax.device_get(params))
    return out


def port_state(tcfg, params):
    """``init_state``'s networks, modes and optimizers for ``tcfg``, holding
    the given tensors."""
    from aas_enhancement_tpu_torch.train.state import TrainState, adam, am_sgd

    f = tcfg.audio.num_bins
    state = TrainState()
    for name, sd in params.items():
        cls, section, _ = _nets()[name]
        net = cls(getattr(tcfg, section), f)
        net.load_state_dict(sd)
        setattr(state, name, net)
    if tcfg.train.objective == "am":
        state.am.train()
        state.am_opt = am_sgd(tcfg, state.am.parameters(), tcfg.train.lr_am)
        if state.g is not None:                    # am_through_enhancer: frozen
            state.g.eval().requires_grad_(False)
        return state
    state.am.eval().requires_grad_(False)
    state.g.train()
    state.d.train()
    state.g_opt = adam(tcfg, state.g.parameters(), tcfg.train.lr_g)
    state.d_opt = adam(tcfg, state.d.parameters(), tcfg.train.lr_d)
    return state


def adam_travel(steps: int, b1: float, b2: float) -> float:
    """The most sum_t |Adam's update at step t| / lr can reach in ``steps``
    steps: |m_t| / sqrt(v_t) <= (1 - b1) / sqrt(1 - b2) x
    sqrt(sum_k<t (b1^2 / b2)^k), times the bias corrections."""
    return sum((1 - b1) / math.sqrt(1 - b2)
               * math.sqrt(sum((b1 * b1 / b2) ** k for k in range(t)))
               * math.sqrt(1 - b2 ** t) / (1 - b1 ** t) for t in range(1, steps + 1))
