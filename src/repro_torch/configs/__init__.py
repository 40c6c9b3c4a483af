# The paper's own configuration; the LM configs and their registry come with
# the LM slice of the port.
from .signal_tree import CONFIG, SignalTreeConfig

__all__ = ["CONFIG", "SignalTreeConfig"]
