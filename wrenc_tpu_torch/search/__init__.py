from .wavefront import WavefrontSearch
