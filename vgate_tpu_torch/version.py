"""Version of the vgate-tpu framework."""

__version__ = "0.1.0"
