from repro_torch.analysis.hlo import parse_collectives, collective_bytes_per_device
from repro_torch.analysis.roofline import HW, roofline_terms

__all__ = ["parse_collectives", "collective_bytes_per_device", "HW",
           "roofline_terms"]
