"""Console color helpers (reference:utils/plotting.py:8-27)."""

from __future__ import annotations


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
