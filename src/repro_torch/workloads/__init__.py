from repro_torch.workloads.decode import DecodeEngine, Request, ServeConfig

__all__ = ["DecodeEngine", "Request", "ServeConfig"]
