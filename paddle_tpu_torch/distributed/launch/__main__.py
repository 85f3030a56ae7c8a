from .main import launch

launch()
