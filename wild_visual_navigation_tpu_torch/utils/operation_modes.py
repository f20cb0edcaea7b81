"""Operation modes (reference utils/operation_modes.py:9-35)."""

from enum import Enum


class WVNMode(Enum):
    DEBUG = 0
    ONLINE = 1
    EXTRACT_LABELS = 2

    @staticmethod
    def from_string(string: str) -> "WVNMode":
        if string == "debug":
            return WVNMode.DEBUG
        if string == "online":
            return WVNMode.ONLINE
        if string == "extract_labels":
            return WVNMode.EXTRACT_LABELS
        raise ValueError(f"unknown mode [{string}]")
