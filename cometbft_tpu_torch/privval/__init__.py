from .file_pv import DoubleSignError, FilePV  # noqa: F401
