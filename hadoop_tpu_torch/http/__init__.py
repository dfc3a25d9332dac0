"""The embedded HTTP server the serving door rides."""
