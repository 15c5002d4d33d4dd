"""Scientific-field data for the port."""
