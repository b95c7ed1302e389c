from .store import garbage_collect, latest_step, restore, restore_into, save

__all__ = ["latest_step", "restore", "restore_into", "save", "garbage_collect"]
