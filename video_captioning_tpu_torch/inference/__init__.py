"""Counterparts of video_captioning_tpu/inference: predictor and server."""
