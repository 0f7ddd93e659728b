"""The chat loop's counters: the live steps start from the engine's count at
the loop's start (the warm-up's replays left out) and move at frames."""
import types

from benchmark import drive


class FakeEngine:
    """Streams two frames a request; each frame follows four live replays."""

    def __init__(self):
        self.decode_stats = dict(replays=120, noop_replays=20, blocks=30)  # the warm-up's

    def generate_stream(self, input_ids, max_new_tokens, **_):
        text = ""
        for i in range(2):
            self.decode_stats["replays"] += 4
            text += " ".join(str(i * 3 + j) for j in range(3)) + " "
            yield text, None


def test_chat_counters_start_at_the_loops_start():
    traffic = types.SimpleNamespace(request=lambda k: types.SimpleNamespace(
        prompt=[1, 2, 3], max_new=6, greedy=True, temperature=0.0, topp=0.9,
        repetition_penalty=1.0))
    loop = drive.ChatLoop(FakeEngine(), traffic, {})
    loop._steps = [(0.0, loop._live_steps())]
    c0 = loop.counters()
    assert c0["steps"] == 100 and c0["at"] == 0.0
    loop._one(0)
    c1 = loop.counters()
    assert c1["steps"] - c0["steps"] == 8
    assert c1["at"] == loop.records[0].times[-1] and loop.records[0].counts == [3, 6]
    assert loop.records[0].tokens == [0, 1, 2, 3, 4, 5]
