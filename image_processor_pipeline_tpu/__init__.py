"""image_processor_pipeline_tpu — batch image-augmentation framework on JAX.

A ground-up rebuild of the capabilities of Tezahc/image_processor_pipeline
(directory-to-directory augmentation pipelines for YOLO detection training),
re-architected for accelerators: transforms execute as jit-compiled JAX/XLA
programs over device-resident padded NHWC batches, fed
by host-side async decode, with the batch axis shardable across a device mesh.

External API parity targets (reference file:line cited per module):
  - ProcessingPipeline / ProcessingStep orchestration  (reference pipeline.py:16-28,502-566)
  - five pairing modes + sample_k                      (reference pipeline.py:148-235)
  - per-item status accounting + JSON run reports      (reference pipeline.py:439-499)
  - YOLO label text format + file-naming schemes       (reference utils/utils.py:67-98)
"""

from image_processor_pipeline_tpu.pipeline import ProcessingPipeline, ProcessingStep
from image_processor_pipeline_tpu.pairing import MODES

__version__ = "0.1.0"

__all__ = ["ProcessingPipeline", "ProcessingStep", "MODES", "__version__"]
