from hdpgpc_torch.data.loader import load_record, list_records, synthetic_beats
from hdpgpc_torch.data.priors import compute_estimators_lds

__all__ = ["load_record", "list_records", "synthetic_beats",
           "compute_estimators_lds"]
