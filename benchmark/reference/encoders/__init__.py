"""The encoders of the reference, one file each, named by the
configurations' ``encoder_type`` (``model.part``)."""
