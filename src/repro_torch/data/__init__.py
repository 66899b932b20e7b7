from .pipeline import ImageStream, TokenStream

__all__ = ["TokenStream", "ImageStream"]
