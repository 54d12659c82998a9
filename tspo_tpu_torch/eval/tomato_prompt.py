"""TOMATO prompt template — extracted verbatim from the reference
(lmms-eval/lmms_eval/tasks/tomato/utils.py:86-120 ``construct_prompt``),
mechanically captured so trailing-space quirks survive.  Placeholders:
{num_frames}, {question}, {index2ans} (the str() of the letter->option
dict, as the reference renders it)."""

TOMATO_PROMPT_TEMPLATE = "You will be provided with {num_frames} separate frames uniformly sampled from a video, the frames are provided in chronological order of the video. Analyze these frames and provide the answer to the question about the video content. Answer the multiple-choice question about the video content. \n\nYou must use these frames to answer the multiple-choice question; do not rely on any externel knowledge or commonsense. \n\n<question> \n{question} \n</question>\n\n<options> \n{index2ans} \n</options>\n\nEven if the information in these separate frames is not enough to answer the question, PLEASE TRY YOUR BEST TO GUESS AN ANSWER WHICH YOU THINK WOULD BE THE MOST POSSIBLE ONE BASED ON THE QUESTION. \n\nDO NOT GENERATE ANSWER SUCH AS 'NOT POSSIBLE TO DETERMINE.' \n"
