"""Small helpers shared by the port's modules."""

__all__ = ["getattr_chain"]


def getattr_chain(obj, chain: str, *args):
    """Chained getattr: getattr_chain(scheme, "weights.symmetric", True)."""
    has_default = len(args) >= 1
    default = args[0] if has_default else None
    res = obj
    for attr_name in chain.split("."):
        if not hasattr(res, attr_name):
            if has_default:
                return default
            raise AttributeError(f"{res} object has no attribute {attr_name!r}")
        res = getattr(res, attr_name)
    return res
