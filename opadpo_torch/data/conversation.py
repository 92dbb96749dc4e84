"""Conversation templates (vicuna_v1 / llama_2).

Behavioral port of LLaVA's ``conversation.py`` templates as used by the
reference (``utils/common_utils.py:336-475`` drives them; the DPO dataset
hard-codes the rendered vicuna_v1 prefix, ``utils/data_utils_dpo.py:292-294``).
Only the two styles the pipeline uses are implemented.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    TWO = "TWO"
    LLAMA_2 = "LLAMA_2"


VICUNA_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's "
    "questions."
)


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[Tuple[str, Optional[str]]]
    sep_style: SeparatorStyle
    sep: str
    sep2: str
    version: str = "v1"

    def copy(self) -> "Conversation":
        return Conversation(self.system, self.roles, list(self.messages),
                            self.sep_style, self.sep, self.sep2, self.version)

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append((role, message))

    def get_prompt(self) -> str:
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(self.messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n" if msg else msg

            def wrap_inst(msg):
                return f"[INST] {msg} [/INST]"

            ret = ""
            for i, (role, message) in enumerate(self.messages):
                if i == 0:
                    assert message, "first message should not be none"
                    assert role == self.roles[0]
                if message:
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        message = wrap_inst(message)
                        ret += self.sep + message
                    else:
                        ret += " " + message + " " + self.sep2
                else:
                    ret += ""
            return ret.lstrip(self.sep)
        raise NotImplementedError(self.sep_style)


conv_vicuna_v1 = Conversation(
    system=VICUNA_SYSTEM,
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_llava_llama_2 = Conversation(
    system=("You are a helpful language and vision assistant. You are able "
            "to understand the visual content that the user provides, and "
            "assist the user with a variety of tasks using natural language."),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

conv_templates = {
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llava_llama_2": conv_llava_llama_2,
}

default_conversation = conv_vicuna_v1

# The rendered query template the DPO dataset uses verbatim
# (utils/data_utils_dpo.py:292-294). Note the '图 ' placeholder that the
# collator maps back to IMAGE_TOKEN_INDEX after tokenization.
DPO_QUERY_PREFIX = (
    "<s> A chat between a curious user and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the user's questions. USER: "
)
DPO_QUERY_SUFFIX = " ASSISTANT: "
