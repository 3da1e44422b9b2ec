"""The frozen Faster R-CNN feature extractor of config 5 (the port of
`nafae_tpu/models/detector`)."""
