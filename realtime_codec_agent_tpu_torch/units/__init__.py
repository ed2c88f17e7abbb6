from .codes import (
    UNICODE_OFFSET,
    UNICODE_OFFSET_LARGE,
    codes_to_chars,
    chars_to_codes,
    interleave_channels,
    deinterleave_channels,
    drop_hanging_channel_codes,
    is_audio_code,
    audio_code_positions,
)
from .special_tokens import SPECIAL_TOKENS
