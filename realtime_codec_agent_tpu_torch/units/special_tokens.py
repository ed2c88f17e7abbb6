"""Special-token framing vocabulary for the duplex codec LM.

Mirrors the token strings in the reference (realtime_agent_config.py:30-38,
lm_dataset_builder.py:30-39). The ORDER of SPECIAL_TOKENS matters: the duplex
agent distinguishes audio tokens from everything else with
``token_id > end_header_token_id`` (reference realtime_agent_v2.py:345, 361),
so ``<|end_header|>`` must be the highest-id special token, directly below the
codec-code region of the vocabulary.
"""

HEADER_AUDIO_ONLY = "<|audio_only|>"
HEADER_TEXT_ONLY = "<|text_only|>"
HEADER_AUDIO_FIRST = "<|audio_first|>"
HEADER_TEXT_FIRST = "<|text_first|>"
HEADER_AGENT = "<|agent|>"
HEADER_AGENT_VOICE = "<|agent_voice|>"
HEADER_SPEAKER = "<|speaker|>"
START_AUDIO = "<|audio|>"
END_AUDIO = "<|end_audio|>"
END_HEADER = "<|end_header|>"

EXTERNAL_MARKER = "†"  # "†" — plain text token, not a special (reference realtime_agent_config.py:38)

# end_header LAST: every codec-code token id must be > end_header_token_id.
SPECIAL_TOKENS = (
    HEADER_AUDIO_ONLY,
    HEADER_TEXT_ONLY,
    HEADER_AUDIO_FIRST,
    HEADER_TEXT_FIRST,
    HEADER_AGENT,
    HEADER_AGENT_VOICE,
    HEADER_SPEAKER,
    START_AUDIO,
    END_AUDIO,
    END_HEADER,
)
