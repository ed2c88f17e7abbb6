"""The child-process agent of the port's multiprocessing tests, and the
codec pin they share with the in-process agents they are held to.

The spawned child imports this module to rebuild its process object, so it
imports nothing of JAX."""
from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgentMultiprocessing


def pin_codec_region(agent, resources) -> None:
    """Every sample restricted to codec ids (the JAX agent's or the port's)."""
    orig = agent.set_sampler

    def pinned(for_trans=False, suppress_end_audio=False):
        orig(for_trans=for_trans, suppress_end_audio=suppress_end_audio)
        resources.llm.settings.min_token_id = resources.tokenizer.codec_vocab_start

    agent.set_sampler = pinned
    agent.set_sampler()


class PinnedAgentProcess(RealtimeAgentMultiprocessing):
    """The port's child process with its agent pinned to the codec region."""

    def _make_agent(self, resources, config, self_play_mode):
        agent = super()._make_agent(resources, config, self_play_mode)
        pin_codec_region(agent, resources)
        return agent
