"""Hardware-control utilities (serial radios, SDR capture).

Optional-dependency layer: pyserial and SoapySDR are imported lazily and a
clear error is raised when absent, so that the rest of the port never
depends on radio hardware being present.
"""

from .rn2483 import RN2483

__all__ = ["RN2483"]
