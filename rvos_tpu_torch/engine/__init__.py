from .eval import UNCERTAIN_LABEL, Evaluator

__all__ = ["UNCERTAIN_LABEL", "Evaluator"]
