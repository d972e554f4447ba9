"""aas_enhancement_tpu_torch — the PyTorch/CUDA port of aas_enhancement_tpu.

The JAX package beside it is the reference; every module here mirrors its
counterpart's path (``dsp/stft.py`` <-> ``aas_enhancement_tpu/dsp/stft.py``)
and is tested against it on the CPU.  The math the JAX package wrote as Pallas
kernels runs here as hand-written Hopper kernels in CUDA C++ (``csrc/*.cu``,
built by ``utils/kernel_build.py``).  A CPU tensor takes each
kernel's plain PyTorch version; a CUDA tensor launches the kernel or raises.

Ported so far: the enhancement path (STFT -> conv + BiLSTM enhancer -> ISTFT),
driven by ``python -m aas_enhancement_tpu_torch.cli.enhance``, and the
recognition path (STFT -> enhancer -> DeepSpeech2 AM with BiGRUs -> greedy
CTC -> WER), driven by ``python -m aas_enhancement_tpu_torch.cli.evaluate``;
the objectives, checkpoints and streaming engines around them; and serving:
the live TCP server (``cli.serve``) and the exported enhancer
(``cli.export``, ``torch.export`` over the kernels registered as operators
in ``ops/library.py``); beam decoding with char / word / hybrid LM fusion
(the host C++ decoder of ``native/`` and the batched beam on the card,
``decode/``), LM training (``cli.train_lm``) and tuning, the native wav
loader and the worker loader.

This package imports torch and never jax or flax.
"""

__version__ = "0.1.0"
