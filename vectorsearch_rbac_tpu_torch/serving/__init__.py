from .server import BatchingServer, SearchRequest, SearchResult, closed_loop

__all__ = ["BatchingServer", "SearchRequest", "SearchResult", "closed_loop"]
