"""The planner's cost models (copies of the reference's models/)."""

from .cost import (CostModelParams, IVFCoverageParams, QueryTimeModel,
                   RecallModel, TPUCostParams, ef_for_recall,
                   model_ef_for_recall, model_partition_time)

__all__ = [
    "CostModelParams", "IVFCoverageParams", "QueryTimeModel", "RecallModel",
    "TPUCostParams", "ef_for_recall", "model_ef_for_recall",
    "model_partition_time",
]
