from .synthetic import SyntheticConfig, generate_case, generate_case_with_spans

__all__ = ["SyntheticConfig", "generate_case", "generate_case_with_spans"]
