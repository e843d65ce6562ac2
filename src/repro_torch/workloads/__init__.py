from repro_torch.workloads.base import (DECODE, SSM, WORKLOAD_CLASSES,
                                        workload_class_of)
from repro_torch.workloads.decode import DecodeEngine, Request, ServeConfig
from repro_torch.workloads.ssm import SSMEngine

__all__ = ["DECODE", "DecodeEngine", "Request", "SSM", "SSMEngine",
           "ServeConfig", "WORKLOAD_CLASSES", "workload_class_of"]
