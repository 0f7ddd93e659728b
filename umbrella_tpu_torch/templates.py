"""Prompt templates, the counterpart of `umbrella_tpu/templates.py`.

The strings are each model family's chat format, character for character the
JAX package's; `Prompts`, `SysPrompts` and `ExtraPrompts` are dict views of
the one registry.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChatTemplate:
    user: str  # format string with one {} slot for the user turn
    system: str = ""  # emitted once at conversation start
    extra: str = ""  # appended to the user text (e.g. code-style nudges)

    def render_turn(self, text: str) -> str:
        return self.user.format(text + self.extra)

    def render_first(self, text: str) -> str:
        return self.system + self.render_turn(text)


_LLAMA3_SYSTEM = (
    "<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
    "You are a knowledgeable, efficient, and direct AI assistant. Provide concise "
    "answers, focusing on the key information needed. Offer suggestions tactfully "
    "when appropriate to improve outcomes. Engage in productive collaboration "
    "with the user. <|eot_id|>"
)

TEMPLATES = {
    "meta-llama3": ChatTemplate(
        user=("\n<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>\n"
              "<|start_header_id|>assistant<|end_header_id|>\n\n"),
        system=_LLAMA3_SYSTEM,
    ),
    "llama3-code": ChatTemplate(
        user=("<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
              "<|start_header_id|>assistant<|end_header_id|>\n\n<|python_tag|>"),
        system=("<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
                "Environment: ipython<|eot_id|>"),
        extra="\nAlways try to wrap what you write in a function.",
    ),
    "qwen": ChatTemplate(
        user="<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n",
        system="<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n",
    ),
    "gemma2-it": ChatTemplate(
        user="<start_of_turn>user\n{}<end_of_turn>\n<start_of_turn>model\n",
    ),
    "gemma2": ChatTemplate(user="{}"),
    "mistral": ChatTemplate(user="[INST] {} [/INST]"),
}

Prompts = {name: t.user for name, t in TEMPLATES.items()}
SysPrompts = {name: t.system for name, t in TEMPLATES.items()}
ExtraPrompts = {name: t.extra for name, t in TEMPLATES.items() if t.extra}
