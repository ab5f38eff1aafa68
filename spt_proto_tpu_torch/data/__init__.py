"""Text data pipelines (port of spt_proto_tpu/data): plain Python and
numpy, batches as dicts of numpy arrays."""
from spt_proto_tpu_torch.data import datamodule, mmlu, reader, transform

__all__ = ['datamodule', 'mmlu', 'reader', 'transform']
