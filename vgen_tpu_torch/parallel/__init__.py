"""Scans over several devices and processes: ``mesh`` and ``distributed``."""
