"""The prediction nets of the reference, one file each, named by the
configurations' ``decoder_type`` (``model.part``)."""
