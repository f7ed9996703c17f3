"""Tune's unit of execution, `Trainable` (reference: ray_tpu.tune). The
rest of Tune is not ported yet (ROADMAP.md queue A item 4.7)."""

from ray_tpu_torch.tune.trainable import (FunctionTrainable, Trainable,
                                          make_function_trainable, report)

__all__ = ["FunctionTrainable", "Trainable", "make_function_trainable",
           "report"]
