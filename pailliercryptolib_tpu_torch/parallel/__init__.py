from .context import get_context, initialize_context, terminate_context
