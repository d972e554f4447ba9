"""Data parallelism over processes (counterpart of ``aas_enhancement_tpu/parallel/``)."""
