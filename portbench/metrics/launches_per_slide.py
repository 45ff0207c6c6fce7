"""``launches_per_slide.tile``: the host's kernel and graph launch calls
in the traced stretch per slide it completed."""

from .launches_per_img import read  # noqa: F401  (the same count per unit)
