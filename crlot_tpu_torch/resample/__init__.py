# polyphase first: it imports kernel, which reads polyphase at call time.
from .polyphase import output_length, resample, resample_chunked  # noqa: F401
from .stream import PolyphaseStreamer  # noqa: F401
