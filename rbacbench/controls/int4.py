"""Control `int4`: each feature in [0, 255] floored to its 16-level bucket,
the step below the program's int8 codes. The reference searches these
codes in the program's place; the check has to call the result not
correct."""

import torch


def codes(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x.to(torch.float32) / 16.0)
