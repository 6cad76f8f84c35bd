"""Conversation prompt templates.

A copy of `grove_tpu/text/conversation.py`, so that the port imports nothing of the JAX
package; `tests/test_torch_misc.py` holds the two equal.

Functional re-design of the reference's `model/llava/conversation.py`
(dataclass with separator-style enum). GROVE flows use `llava_v1`
(Vicuna v1, SeparatorStyle.TWO, `conversation.py:355-365`) and
`llava_llama_2`; the remaining separator styles the reference declares
(SINGLE / MPT / PLAIN, `conversation.py:6-105`) are provided as subclasses
for template completeness.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    sep: str
    sep2: str
    messages: List[Tuple[str, str]] = dataclasses.field(default_factory=list)

    def copy(self) -> "Conversation":
        return type(self)(self.system, self.roles, self.sep, self.sep2,
                          list(self.messages))

    def append_message(self, role: str, message: str | None) -> None:
        self.messages.append((role, message))

    def get_prompt(self) -> str:
        """Vicuna-v1 style (SeparatorStyle.TWO): alternating sep/sep2."""
        seps = [self.sep, self.sep2]
        ret = self.system + seps[0]
        for i, (role, message) in enumerate(self.messages):
            if message:
                ret += role + ": " + message + seps[i % 2]
            else:
                ret += role + ":"
        return ret


LLAVA_V1 = Conversation(
    system=("A chat between a curious human and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the human's questions."),
    roles=("USER", "ASSISTANT"),
    sep=" ",
    sep2="</s>",
)


@dataclasses.dataclass
class Llama2Conversation(Conversation):
    """LLAMA_2 separator style (`conversation.py:72-93` of the reference):
    [INST] ... [/INST] wrapping with <<SYS>> on the first turn."""

    def get_prompt(self) -> str:
        wrap_sys = lambda msg: f"<<SYS>>\n{msg}\n<</SYS>>\n\n"  # noqa: E731
        wrap_inst = lambda msg: f"[INST] {msg} [/INST]"          # noqa: E731
        ret = ""
        for i, (role, message) in enumerate(self.messages):
            if message:
                if i == 0:
                    message = wrap_sys(self.system) + message
                if i % 2 == 0:
                    ret += self.sep + wrap_inst(message)
                else:
                    ret += " " + message + " " + self.sep2
            else:
                ret += ""
        return ret.lstrip(self.sep)


LLAVA_LLAMA_2 = Llama2Conversation(
    system=("You are a helpful language and vision assistant. You are able "
            "to understand the visual content that the user provides, and "
            "assist the user with a variety of tasks using natural "
            "language."),
    roles=("USER", "ASSISTANT"),
    sep="<s>",
    sep2="</s>",
)


@dataclasses.dataclass
class SingleSepConversation(Conversation):
    """SeparatorStyle.SINGLE: one separator after every turn."""

    def get_prompt(self) -> str:
        ret = self.system + self.sep
        for role, message in self.messages:
            if message:
                ret += role + ": " + message + self.sep
            else:
                ret += role + ":"
        return ret


@dataclasses.dataclass
class MptConversation(Conversation):
    """SeparatorStyle.MPT: role tag directly concatenated with the message."""

    def get_prompt(self) -> str:
        ret = self.system + self.sep
        for role, message in self.messages:
            if message:
                ret += role + message + self.sep
            else:
                ret += role
        return ret


@dataclasses.dataclass
class PlainConversation(Conversation):
    """SeparatorStyle.PLAIN: messages only, alternating sep/sep2, no roles."""

    def get_prompt(self) -> str:
        seps = [self.sep, self.sep2]
        ret = self.system
        for i, (_, message) in enumerate(self.messages):
            if message:
                ret += message + seps[i % 2]
        return ret


LLAVA_V0 = SingleSepConversation(
    system=("A chat between a curious human and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the human's questions."),
    roles=("Human", "Assistant"),
    sep="###",
    sep2="",
)

LLAVA_PLAIN = PlainConversation(system="", roles=("", ""), sep="",
                                sep2="\n")

CONV_TEMPLATES = {"llava_v1": LLAVA_V1, "llava_llama_2": LLAVA_LLAMA_2,
                  "llava_v0": LLAVA_V0, "plain": LLAVA_PLAIN}


def build_prompt(instruction: str, answer: str = "",
                 template: str = "llava_v1") -> str:
    """One-round USER/ASSISTANT prompt; empty answer leaves `ASSISTANT:` open.

    Matches the reference prompt builders (`infer_iground.py:62-85`,
    dataset conversation assembly).
    """
    conv = CONV_TEMPLATES[template].copy()
    conv.append_message(conv.roles[0], instruction)
    conv.append_message(conv.roles[1], answer if answer else None)
    return conv.get_prompt()


def answer_separator(template: str = "llava_v1") -> str:
    """Separator preceding assistant output — used for CE target masking."""
    conv = CONV_TEMPLATES[template]
    return conv.sep + conv.roles[1] + ": "
