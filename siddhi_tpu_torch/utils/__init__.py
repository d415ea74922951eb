"""Helpers of the port that depend on neither torch nor the device."""
