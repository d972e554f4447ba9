"""Convert a train-CLI checkpoint directory of the JAX package (Orbax) into the
PyTorch port's format (``aas_enhancement_tpu_torch/utils/checkpoint.py``).

Reads the newest step with ``aas_enhancement_tpu.utils.checkpoint.
restore_rehosted`` and the directory's ``config.json``, maps ``g_params``,
``d_params`` and ``am_params`` with the port's ``convert.py``, loads them
into the port's networks of that config (so a mismatch raises here, not
later), and writes ``DST/<step>/state.pt`` with the step and a copy of
``config.json``.  A G that the objective does not train (an ``am`` run given
``--g-checkpoint``) is kept, frozen, as the JAX ``load_state`` returns it.  Networks only, as the JAX ``load_state`` restores networks
only: the optimizer states are not converted, so ``--continue-from`` on the
result raises ("no optimizer state"); evaluate, enhance, ``--am-checkpoint``
and ``--g-checkpoint`` take it.

Needs JAX and Orbax (runs on the host, on the CPU); the port itself never
imports them.

Usage:
  python scripts/orbax_to_torch.py SRC_DIR DST_DIR
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(src: str, dst: str) -> int:
    """SRC (a JAX train-CLI checkpoint dir) -> DST (the port's format); the
    converted step."""
    import jax

    from aas_enhancement_tpu.utils import checkpoint as jckpt
    from aas_enhancement_tpu_torch.config import Config
    from aas_enhancement_tpu_torch.convert import (am_params_from_flax,
                                                   disc_params_from_flax,
                                                   enhancer_params_from_flax)
    from aas_enhancement_tpu_torch.train.loop import init_state, keep_frozen_g
    from aas_enhancement_tpu_torch.utils import checkpoint as tckpt

    cfg_path = os.path.join(src, "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f"{src}: no config.json — not a train-CLI checkpoint dir")
    mgr = jckpt.make_manager(src)
    try:
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {src}")
        raw = jax.device_get(jckpt.restore_rehosted(mgr, step))
    finally:
        mgr.close()
    with open(cfg_path) as f:
        cfg = Config.from_json(f.read())

    state = init_state(cfg, 0, "cpu")
    for name, key, fn in (("g", "g_params", enhancer_params_from_flax),
                          ("d", "d_params", disc_params_from_flax),
                          ("am", "am_params", am_params_from_flax)):
        if raw.get(key):
            net = keep_frozen_g(state, cfg, "cpu") if name == "g" else getattr(state, name)
            net.load_state_dict(fn(raw[key]))
        else:
            setattr(state, name, None)
        setattr(state, name + "_opt", None)
    state.step = int(raw.get("step", step))
    if tckpt.latest_step(dst) is not None:
        raise FileExistsError(f"{dst} already holds a checkpoint")
    tckpt.save(dst, state.step, state)
    shutil.copyfile(cfg_path, os.path.join(dst, "config.json"))
    return state.step


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src", help="the JAX package's train-CLI checkpoint dir")
    p.add_argument("dst", help="the port's checkpoint dir to write")
    args = p.parse_args(argv)
    step = convert(args.src, args.dst)
    print(json.dumps({"step": step, "dst": args.dst}))


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")     # conversion needs no accelerator
    main()
