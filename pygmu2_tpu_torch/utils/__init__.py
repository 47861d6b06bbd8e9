"""User utilities of the port: playback and offline renders (``browse``
opens a render in the jog/shuttle player, ``utils/jogshuttle.py``), WAV and
FLAC codecs, assets, temperaments and conversions."""

from pygmu2_tpu_torch.utils.playback import (  # noqa: F401
    browse,
    play,
    play_offline,
    render_to_array,
    render_to_file,
)
