"""Persistence and replay: episode logs, checkpoints, preprocessing; and
online serving (io/server, io/fleet, imported by name)."""
from . import logs, replay
from .logs import EpisodeLog, load_pytree, save_pytree

__all__ = ["logs", "replay", "EpisodeLog", "save_pytree", "load_pytree"]
