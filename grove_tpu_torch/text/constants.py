"""Special-token string constants and sentinel indices.

A copy of `grove_tpu/text/constants.py`, so that the port imports nothing of the JAX
package; `tests/test_torch_misc.py` holds the two equal.

Mirrors `utils/utils.py:9-25` of the reference. The numeric sentinels are
protocol constants shared with the published checkpoints' data pipeline.
"""

IGNORE_INDEX = -100
VIDEO_TOKEN_INDEX = -200          # splice sentinel (IMAGE_TOKEN_INDEX)

DEFAULT_VIDEO_TOKEN = "<video>"
DEFAULT_VID_START_TOKEN = "<vid_start>"
DEFAULT_VID_END_TOKEN = "<vid_end>"
DEFAULT_BBOX_TOKEN = "<bbox>"
DEFAULT_POINT_TOKEN = "<point>"
DET_TOKEN = "[DET]"
BOP_TOKEN = "<p>"
EOP_TOKEN = "</p>"

DEFAULT_EOS_TOKEN = "</s>"
DEFAULT_BOS_TOKEN = "<s>"
DEFAULT_UNK_TOKEN = "<unk>"

# Special tokens appended to the base LLaMA vocab, in the exact order the
# reference adds them (`train.py:124-152`): first the vid start/end pair,
# then region tokens, then [DET], then the phrase tags.
GROVE_EXTRA_TOKENS = (
    DEFAULT_VID_START_TOKEN,
    DEFAULT_VID_END_TOKEN,
    DEFAULT_BBOX_TOKEN,
    DEFAULT_POINT_TOKEN,
    DET_TOKEN,
    BOP_TOKEN,
    EOP_TOKEN,
)
