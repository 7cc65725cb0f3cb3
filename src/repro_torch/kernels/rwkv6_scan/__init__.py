from repro_torch.kernels.rwkv6_scan.ops import wkv6
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

__all__ = ["wkv6", "wkv6_ref"]
