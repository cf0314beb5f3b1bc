from repro_torch.runtime.executor import DeviceBlockTable, Executor

__all__ = ["DeviceBlockTable", "Executor"]
