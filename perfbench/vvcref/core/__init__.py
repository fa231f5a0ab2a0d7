from .config import EncoderConfig, RateModelConfig
from . import tables
