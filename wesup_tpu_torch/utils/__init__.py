"""Utilities of the port: device-side metrics, per-epoch history, record
directories."""


def underline(content: str, style: str = "-") -> str:
    """Underline a sentence (reference utils/__init__.py:4-7)."""
    return content + "\n" + style * len(content.strip())
