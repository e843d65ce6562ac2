from repro_torch.workloads.base import (DECODE, ENCDEC, ENCODER, SSM,
                                        WORKLOAD_CLASSES, build_engine,
                                        workload_class_of)
from repro_torch.workloads.decode import DecodeEngine, Request, ServeConfig
from repro_torch.workloads.encdec import EncDecEngine
from repro_torch.workloads.encoder import EncodeJob, EncoderEngine
from repro_torch.workloads.ssm import SSMEngine

__all__ = ["DECODE", "DecodeEngine", "ENCDEC", "ENCODER", "EncDecEngine",
           "EncodeJob", "EncoderEngine", "Request", "SSM", "SSMEngine",
           "ServeConfig", "WORKLOAD_CLASSES", "build_engine",
           "workload_class_of"]
