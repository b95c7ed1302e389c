from .pipeline import SyntheticLM, make_batch_specs

__all__ = ["SyntheticLM", "make_batch_specs"]
