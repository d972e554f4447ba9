"""Whether training gives the same bits twice, and where two runs part.

    python -m aas_enhancement_tpu_torch.utils.determinism [--objective am|aas]
        [--steps 20] [--n-utts 64] [--batch-size 16] [--device cuda]
        [--deterministic]

Builds the e2e protocol's configuration (``cli/e2e.py::cfg_for``) for the
objective and its synthetic train corpus (seed 7, 0-10 dB), then:

1. runs ``train/loop.py::train`` twice for ``--steps`` steps from the same
   initial state (``init_state`` from the config's seed) and compares every
   record's losses and every parameter at the end, bit for bit;
2. runs the first step's gradients (``make_train_step(cfg).batch_grads`` on
   the first batch ``train`` takes) twice from one state, with hooks on every
   module of the networks: the first module, in forward order, whose output
   differs between the two runs, the first module, in backward order, at
   whose output the gradient differs, and every parameter gradient that
   differs.

``--deterministic`` sets ``torch.use_deterministic_algorithms(True,
warn_only=True)`` and ``torch.backends.cudnn.deterministic`` first: the
warnings collected name the operations that have no deterministic
implementation on the device.  Prints one JSON object as the last line.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
import warnings

import torch

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.data.dataset import AudioDataset, UnpairedCleanStream
from aas_enhancement_tpu_torch.data.synthetic import generate_corpus
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.parallel.mesh import make_mesh
from aas_enhancement_tpu_torch.train.loop import batch_dict, init_state, train
from aas_enhancement_tpu_torch.train.state import TrainState
from aas_enhancement_tpu_torch.train.steps import make_train_step

NETWORKS = ("g", "d", "am")


def _diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """0.0 where a and b hold the same bits, else their max abs difference
    (inf where the shapes differ)."""
    if a.shape != b.shape:
        return float("inf")
    if torch.equal(a, b):
        return 0.0
    return max(float((a.double() - b.double()).abs().max()), 1e-300)


def _traced_grads(cfg: Config, state: TrainState, batch: dict) -> tuple[dict, list, list]:
    """One step's gradients with every module's output and the gradient at
    it recorded: -> (grads {network: {name: tensor}}, [(module, output)] in
    forward order, [(module, d output)] in backward order)."""
    forward, backward, handles = [], [], []

    def hook(name):
        def record(_module, _args, out):
            if isinstance(out, torch.Tensor) and out.is_floating_point():
                forward.append((name, out.detach().clone()))
                if out.requires_grad:
                    out.register_hook(lambda g: backward.append((name, g.detach().clone())))
        return record

    for net in NETWORKS:
        module = getattr(state, net, None)
        if module is not None:
            for name, sub in module.named_modules():
                handles.append(sub.register_forward_hook(hook(f"{net}.{name}" if name else net)))
    try:
        grads, _ = make_train_step(cfg).batch_grads(state, batch)
    finally:
        for h in handles:
            h.remove()
    return grads, forward, backward


def _first_diff(a: list, b: list) -> dict | None:
    for (name, x), (name_b, y) in zip(a, b):
        if name != name_b:
            return {"module": name, "other_run": name_b, "max_abs_diff": float("inf")}
        d = _diff(x, y)
        if d:
            return {"module": name, "max_abs_diff": d}
    return None if len(a) == len(b) else {"module": "(a different number of modules ran)"}


def probe(cfg: Config, manifests: dict, steps: int, device: torch.device,
          deterministic: bool = False) -> dict:
    """The two comparisons of the module docstring -> a JSON-ready dict."""
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    objective = cfg.train.objective
    clean = manifests["clean"] if objective == "aas" else None
    noisy = manifests["clean"] if objective == "am" else manifests["noisy"]
    seed = cfg.train.seed
    out: dict = {"objective": objective, "device": str(device), "deterministic": deterministic,
                 "steps": steps}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        # 1. The whole run, twice.
        runs = [train(cfg, noisy, clean, max_steps=steps, state=init_state(cfg, seed, device),
                      device=device) for _ in range(2)]
        (s1, r1), (s2, r2) = runs
        timed = ("utts_per_sec",)         # host clock, not the run's numbers
        out["records_equal"] = ([{k: v for k, v in r.items() if k not in timed} for r in r1]
                                == [{k: v for k, v in r.items() if k not in timed} for r in r2])
        out["losses"] = {k: {"first": [r1[0][k], r2[0][k]], "last": [r1[-1][k], r2[-1][k]]}
                         for k in r1[-1] if k.startswith("loss")}
        params = {}
        for net in NETWORKS:
            a, b = getattr(s1, net, None), getattr(s2, net, None)
            if a is not None:
                for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
                    if _diff(p, q):
                        params[f"{net}.{name}"] = _diff(p, q)
        out["params_differ"] = params

        # 2. The first step's gradients, twice from one state, traced.
        mesh = make_mesh(cfg.mesh, device)
        ds = AudioDataset(noisy, cfg.audio, cfg.data)
        batch = next(iter(ds.batches(cfg.train.batch_size, seed, 0,
                                     sorted_order=cfg.train.sortagrad)))
        stream = (UnpairedCleanStream(AudioDataset(clean, cfg.audio, cfg.data),
                                      cfg.train.batch_size, seed=seed + 1) if clean else None)
        bd = batch_dict(cfg, batch, stream, mesh)
        state = init_state(cfg, seed, device)
        traced = [_traced_grads(cfg, copy.deepcopy(state), bd) for _ in range(2)]
        (g1, f1, b1), (g2, f2, b2) = traced
        out["step1_grads_differ"] = {f"{net}.{n}": _diff(t, g2[net][n])
                                     for net in g1 for n, t in g1[net].items()
                                     if _diff(t, g2[net][n])}
        out["step1_first_forward_diff"] = _first_diff(f1, f2)
        out["step1_first_backward_diff"] = _first_diff(b1, b2)
        out["modules_traced"] = len(f1)
    if deterministic:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    out["warnings"] = sorted({str(w.message).splitlines()[0][:300] for w in caught
                              if "deterministic" in str(w.message)})
    out["bit_reproducible"] = (out["records_equal"] and not params
                               and not out["step1_grads_differ"])
    return out


def main(argv=None) -> dict:
    from aas_enhancement_tpu_torch.cli.e2e import CORPUS_SEEDS, cfg_for
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--objective", choices=("am", "aas"), default="am")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--n-utts", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--device", default="cuda")
    p.add_argument("--deterministic", action="store_true")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.deterministic:
        # cuBLAS's own condition for reproducible results (set before its first call).
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = cfg_for(args.objective, args.batch_size, 0.2)
    with tempfile.TemporaryDirectory() as tmp:
        manifests = generate_corpus(os.path.join(tmp, "corpus"), n_utts=args.n_utts,
                                    seed=CORPUS_SEEDS["corpus"], snr_range=(0.0, 10.0),
                                    n_words=(3, 8), reverb_prob=0.3)
        with open(os.devnull, "w") as null:     # train's records go to stderr
            stderr, sys.stderr = sys.stderr, null
            try:
                out = probe(cfg, manifests, args.steps, device, args.deterministic)
            finally:
                sys.stderr = stderr
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
