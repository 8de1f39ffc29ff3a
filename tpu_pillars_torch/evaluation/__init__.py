from tpu_pillars_torch.evaluation.map_eval import (
    EvalBox, get_average_precisions, lyft_map,
)
from tpu_pillars_torch.evaluation.map_eval_alt import lyft_map_alt
from tpu_pillars_torch.evaluation.tta import predict_tta

__all__ = ["EvalBox", "get_average_precisions", "lyft_map", "lyft_map_alt",
           "predict_tta"]
