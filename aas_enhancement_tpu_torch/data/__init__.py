"""Host-side data I/O: WAV files, manifests and a synthetic corpus."""

from aas_enhancement_tpu_torch.data.manifest import read_manifest  # noqa: F401
from aas_enhancement_tpu_torch.data.synthetic import generate_corpus  # noqa: F401
from aas_enhancement_tpu_torch.data.wav import read_wav, write_wav  # noqa: F401

__all__ = ["generate_corpus", "read_manifest", "read_wav", "write_wav"]
