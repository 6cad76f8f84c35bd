"""Instruction templates and video-token prompt assembly.

A copy of `grove_tpu/text/prompts.py`, so that the port imports nothing of the JAX
package; `tests/test_torch_misc.py` holds the two equal.

Question template strings are data constants shared with the reference
(`dataset/utils/utils.py:87-103`); prompt assembly mirrors
`infer_iground.py:62-85` and `mm_utils.py:tokenizer_image_token`.
"""

from __future__ import annotations

from typing import List, Sequence

from .constants import (DEFAULT_VID_END_TOKEN, DEFAULT_VID_START_TOKEN,
                        DEFAULT_VIDEO_TOKEN, VIDEO_TOKEN_INDEX)
from .conversation import build_prompt

VIDEO_GROUNDING_QUESTIONS = [
    'Could you please give me a description of the video? Please respond with interleaved bounding boxes for the corresponding parts of the answer.',
    'Can you provide a description of the this video? Please output with interleaved bounding boxes for the corresponding phrases.',
    'Please describe the contents of the video. Please respond with interleaved bounding boxes for the corresponding parts of the answer.',
    'Could you give an explanation of what can be found within this video? Please output with interleaved bounding boxes for the corresponding phrases.',
    'Could you give me an explanation of this video? Please respond with interleaved bounding boxes for the corresponding phrases.',
    'Could you provide me with an analysis of this video? Please output with interleaved bounding boxes for the corresponding parts of the answer.',
]

VIDEO_STG_QUESTIONS = [
    'Could you please give me a description of the video? Please include a single bounding box per frame capturing the activity described in the caption.',
    'Can you provide a description of this video? Each frame should have one bounding box that encapsulates the activity described by the caption.',
    'Please describe the contents of the video. Include one bounding box per frame that highlights the activity mentioned in the caption.',
    'Could you give an explanation of what can be found within this video? For each frame, provide a bounding box that encapsulates the described activity.',
    'Could you give me an explanation of this video? Ensure there is one bounding box per frame to represent the activity described in the caption.',
    'Could you provide me with an analysis of this video? Include a bounding box in each frame encapsulating the activity outlined in the caption.',
]

VIDEO_PREFIX = "The " + DEFAULT_VIDEO_TOKEN + " provides an overview of the video.\n"


def video_instruction(question: str, use_vid_start_end: bool = True) -> str:
    """Prefix the instruction with the video placeholder (+ start/end wrap)."""
    prompt = VIDEO_PREFIX + question
    if use_vid_start_end:
        replace = (DEFAULT_VID_START_TOKEN + DEFAULT_VIDEO_TOKEN
                   + DEFAULT_VID_END_TOKEN)
        prompt = prompt.replace(DEFAULT_VIDEO_TOKEN, replace)
    return prompt


def grounding_prompt(question: str | None = None, answer: str = "",
                     use_vid_start_end: bool = True) -> str:
    """Full llava_v1 conversation prompt with the video placeholder."""
    q = question if question is not None else VIDEO_GROUNDING_QUESTIONS[0]
    return build_prompt(video_instruction(q, use_vid_start_end), answer)


def tokenize_with_video(prompt: str, tokenizer,
                        video_token_index: int = VIDEO_TOKEN_INDEX) -> List[int]:
    """Tokenize a prompt containing `<video>`, inserting the splice sentinel.

    Re-implements `mm_utils.py:tokenizer_image_token:18-43`: each chunk is
    tokenized independently (the tokenizer adds BOS per chunk; BOS is kept
    only for the first chunk) and a single sentinel id is placed between
    chunks.
    """
    chunks = [tokenizer(c).input_ids for c in prompt.split(DEFAULT_VIDEO_TOKEN)]

    input_ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(chunks[0][0])

    sep = [video_token_index] * (offset + 1)
    merged: List[List[int]] = []
    for i, c in enumerate(chunks):
        merged.append(c)
        if i != len(chunks) - 1:
            merged.append(sep)
    for x in merged:
        input_ids.extend(x[offset:])
    return input_ids
