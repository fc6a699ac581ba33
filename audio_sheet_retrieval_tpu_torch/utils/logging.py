"""Console color helpers and model summaries.

Parity: reference:utils/plotting.py:8-27 (BColors) and
reference:utils/monitoring.py:10-34 (print_architecture), as in the JAX
package's ``utils/logging.py``; a module's table lists its named parameters
and buffers.
"""

from __future__ import annotations

from torch import nn


class BColors:
    HEADER = "\033[95m"
    OKBLUE = "\033[94m"
    OKGREEN = "\033[92m"
    WARNING = "\033[93m"
    FAIL = "\033[91m"
    ENDC = "\033[0m"
    BOLD = "\033[1m"
    UNDERLINE = "\033[4m"

    def print_colored(self, string: str, color: str) -> str:
        return color + str(string) + BColors.ENDC


def _named_tensors(module: nn.Module):
    yield from module.named_parameters()
    yield from module.named_buffers()


def count_params(module: nn.Module) -> int:
    """Elements of every parameter and buffer (the JAX package counts every
    leaf of its tree, running state included)."""
    return sum(t.numel() for _, t in _named_tensors(module))


def print_architecture(module: nn.Module, name: str = "model") -> str:
    """Table of a module's parameters and buffers (analog of
    monitoring.py:10-34)."""
    lines = [f"architecture of {name}:"]
    for key, t in _named_tensors(module):
        lines.append(f"  {key:<48} {str(tuple(t.shape)):<20} "
                     f"{str(t.dtype).replace('torch.', '')}")
    lines.append(f"  total parameters: {count_params(module):,}")
    out = "\n".join(lines)
    print(out)
    return out
