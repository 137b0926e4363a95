"""Camera conditioning of the port: geometry, pose encoder, context adaptor."""
