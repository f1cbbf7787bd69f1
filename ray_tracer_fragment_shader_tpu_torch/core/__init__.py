from .renderer import (render_image, render_image_jit, render_pixels,
                       render_rays, render_rays_chain, render_rays_tree)

__all__ = ["render_image", "render_image_jit", "render_pixels", "render_rays",
           "render_rays_chain", "render_rays_tree"]
