"""Plugin discovery: methods and dataparsers registered by other packages."""
