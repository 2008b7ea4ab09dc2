from .resize import ResizeHead

__all__ = ["ResizeHead"]
