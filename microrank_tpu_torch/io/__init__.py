from .interning import Vocab

__all__ = ["Vocab"]
