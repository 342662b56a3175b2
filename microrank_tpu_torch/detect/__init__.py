from .detector import DetectResult, detect_numpy
from .slo import slo_quantile

__all__ = ["DetectResult", "detect_numpy", "slo_quantile"]
