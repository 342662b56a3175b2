from .results import ResultSink, WindowResult
from .table_runner import TableRCA, run_rca_native

__all__ = ["ResultSink", "TableRCA", "WindowResult", "run_rca_native"]
