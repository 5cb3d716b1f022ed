"""Tiling, streaming and host<->device transfer on a torch device."""
