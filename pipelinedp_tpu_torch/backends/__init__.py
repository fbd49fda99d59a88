"""Execution backends of the port."""

from pipelinedp_tpu_torch.backends.torch_backend import TorchBackend

__all__ = ["TorchBackend"]
