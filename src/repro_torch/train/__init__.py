"""Training: AdamW optimizer and the train step of the port."""
