"""Models of the port: the decoder LM (``transformer``) and its paged
slot decoding (``decode``)."""
