"""Angle helpers, songs, profiling and rendering."""
from . import angles, profiling, songs, viz

__all__ = ["angles", "songs", "profiling", "viz"]
