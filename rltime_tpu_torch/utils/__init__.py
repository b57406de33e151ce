"""Ported utilities: seeds, loggers, phase timers."""
