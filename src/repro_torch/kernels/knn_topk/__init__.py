from repro_torch.kernels.knn_topk.ops import row_top2_regret
from repro_torch.kernels.knn_topk.ref import row_top2_regret_ref

__all__ = ["row_top2_regret", "row_top2_regret_ref"]
