from .formulas import FORMULAS, METHODS, spectrum_scores

__all__ = ["FORMULAS", "METHODS", "spectrum_scores"]
