from repro_torch.models.model import Model, build_model
from repro_torch.models.runtime import CPU_TEST, Runtime

__all__ = ["Model", "build_model", "Runtime", "CPU_TEST"]
