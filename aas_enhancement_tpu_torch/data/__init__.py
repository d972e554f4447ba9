"""Host-side data I/O: WAV files, manifests, a synthetic corpus and batches."""

from aas_enhancement_tpu_torch.data.dataset import AudioDataset, Batch  # noqa: F401
from aas_enhancement_tpu_torch.data.manifest import (  # noqa: F401
    read_manifest, read_transcript)
from aas_enhancement_tpu_torch.data.synthetic import generate_corpus  # noqa: F401
from aas_enhancement_tpu_torch.data.wav import read_wav, write_wav  # noqa: F401

__all__ = ["AudioDataset", "Batch", "generate_corpus", "read_manifest",
           "read_transcript", "read_wav", "write_wav"]
