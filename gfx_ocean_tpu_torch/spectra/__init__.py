from .phillips import (dispersion, jonswap_spectrum, phillips_spectrum,
                       spectrum, synthesize)

__all__ = ["dispersion", "jonswap_spectrum", "phillips_spectrum", "spectrum",
           "synthesize"]
